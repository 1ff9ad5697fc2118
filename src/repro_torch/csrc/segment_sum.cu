// CSR segment sum with f32 accumulation (the unfused plan's float-sum
// aggregation of materialised edge messages).
//
// Replaces: src/repro/kernels/segment_sum.py:segment_sum (pallas_call at
// :101, body _kernel :36).
//
// Bound: memory.  It reads the row pointers (4 B per segment), one live
// byte per entry in a segment's range, every live message once (4 B per
// column), and writes the [nl * V, D] result.
//
// Design: the TPU kernel summed one-hot matmuls over a (vertex-block,
// edge-block) grid with band skipping.  Here the messages arrive in the
// aggregation side's CSR order, so the graph's row pointers (agg_ptr) give
// each segment its range; one thread owns one (segment, column) and adds
// the live entries of [ptr[v], ptr[v+1]) sequentially in ascending order,
// skipping dead ones as triplet.cu does.  Same ranges, same order: it is
// bit-equal to the fused triplet kernel's sum over the same edges.
#include <cuda_runtime.h>

extern "C" __global__ void segment_sum_kernel(
    const float* __restrict__ msgs, int d,
    const unsigned char* __restrict__ live, const int* __restrict__ ptr,
    int nl, int v, int e_blk, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nl * v * d) return;
  const long long seg = t / d;
  const int col = (int)(t % d);
  const int q = (int)(seg / v);
  const int s = (int)(seg % v);
  const int* rp = ptr + (long long)q * (v + 1);
  const long long ebase = (long long)q * e_blk;
  float acc = 0.0f;
  for (int i = rp[s]; i < rp[s + 1]; ++i) {
    const long long e = ebase + i;
    if (live[e]) acc = acc + msgs[e * d + col];
  }
  out[t] = acc;
}

extern "C" int launch(const void* msgs, int d, const void* live,
                      const void* ptr, int nl, int v, int e_blk, void* out,
                      void* stream) {
  const long long total = (long long)nl * v * d;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    segment_sum_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)msgs, d, (const unsigned char*)live, (const int*)ptr,
        nl, v, e_blk, (float*)out);
  return (int)cudaGetLastError();
}
