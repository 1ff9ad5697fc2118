// Fused mrTriplets sweep: gather both endpoint rows, run the edge UDF,
// reduce into the aggregation slot — one pass, messages never reach memory.
//
// Replaces: src/repro/kernels/triplet.py:fused_triplet (pallas_call at :447,
// body _make_kernel :246, segmented_reduce_mxu :192).
//
// Bound: memory.  Per live edge it reads the CSR entry (and src_perm for
// to=src), the edge's slots (4 B each side used), its live byte, its packed
// edge payload (4 B/column) and the used mirror rows (4 B/column/side), which
// are random gathers; per slot it writes dm+1 floats.  The arithmetic is a
// few flops per edge.
//
// Design: the TPU kernel grouped edges into 512-edge chunks by (out-block,
// in-block) to gather and scatter with one-hot MXU matmuls over a
// sequential grid.  Here one thread owns one (aggregation slot, message
// column) and walks the slot's CSR range [ptr[v], ptr[v+1]) in ascending
// order (through perm where the edges are not stored in that side's
// order): no atomics, no tree reduction, no padding.  Dead edges are skipped
// before the UDF runs, so 0/0 on a masked edge never reaches the sum.  The
// f32 sum is sequential in edge order, the same order segment_sum.cu uses
// for the unfused plan, so the two plans agree bit for bit.  A hub slot's
// thread walks all of its edges alone: that serial tail is the known cost.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

//@GENERATED@

extern "C" __global__ void triplet_kernel(
    const float* __restrict__ x, long long dx,
    const float* __restrict__ ev, long long de,
    const int* __restrict__ src_slot, const int* __restrict__ dst_slot,
    const unsigned char* __restrict__ live, const int* __restrict__ ptr,
    const int* __restrict__ perm, int nl, int v_mir, int e_blk,
    float* __restrict__ out, float* __restrict__ cnt) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nl * v_mir * DM) return;
  const long long slot = t / DM;
  const int col = (int)(t % DM);
  const int q = (int)(slot / v_mir);
  const int v = (int)(slot % v_mir);
  const int* rp = ptr + (long long)q * (v_mir + 1);
  const int begin = rp[v], end = rp[v + 1];
  const long long ebase = (long long)q * e_blk;
  const float* xq = x + (long long)q * v_mir * dx;
  float acc = IDENT;
  int n = 0;
  for (int i = begin; i < end; ++i) {
    const long long e = ebase + (PERMUTED ? perm[ebase + i] : i);
    if (!live[e]) continue;
    const float* xs = USE_SRC ? xq + (long long)src_slot[e] * dx : nullptr;
    const float* xd = USE_DST ? xq + (long long)dst_slot[e] * dx : nullptr;
    float msg[DM];
    udf_msg(xs, ev + e * de, xd, msg);
    acc = REDUCE(acc, msg[col]);
    ++n;
  }
  out[slot * DM + col] = acc;
  if (col == 0) cnt[slot] = (float)n;
}

extern "C" int launch(const void* x, long long dx, const void* ev,
                      long long de, const void* src_slot,
                      const void* dst_slot, const void* live,
                      const void* ptr, const void* perm, int nl, int v_mir,
                      int e_blk, void* out, void* cnt, void* stream) {
  const long long total = (long long)nl * v_mir * DM;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    triplet_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, dx, (const float*)ev, de, (const int*)src_slot,
        (const int*)dst_slot, (const unsigned char*)live, (const int*)ptr,
        (const int*)perm, nl, v_mir, e_blk, (float*)out, (float*)cnt);
  return (int)cudaGetLastError();
}
