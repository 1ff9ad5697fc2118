// Fused mrTriplets sweep: gather both endpoint rows, run the edge UDF,
// reduce into the aggregation slot — messages never reach device memory.
//
// Replaces: src/repro/kernels/triplet.py:fused_triplet (pallas_call at :447,
// body _make_kernel :246, segmented_reduce_mxu :192), and with it
// src/repro/kernels/spmv.py:spmv, which runs the same pallas_call.
//
// Bound: bytes.  Per live edge it reads its CSR position's index streams
// (perm for to=src, the edge's slots, its live byte, its edge payload at 4 B
// a column) and gathers the used endpoint rows of x at random; per slot it
// writes dm + 1 floats.  The UDF is a few operations per edge.
//
// Design: the TPU kernel grouped edges into 512-edge chunks by (out-block,
// in-block) to gather and scatter with one-hot MXU matmuls over a
// sequential grid.  Here the order of segorder.cuh (inlined below) cuts
// every slot's CSR range into pieces of at most SEG_PIECE edges.  A warp
// takes 32 pieces, one a lane; the warp stages its span a window at a time,
// lane l taking positions l, l + 32, ...: coalesced index reads, 32
// independent row gathers in flight, the UDF evaluated once per live edge
// (dead edges skip it, so 0/0 on a masked edge never reaches the sum), all
// dm columns at once.  Each lane then reduces its piece from shared memory.
// No thread walks more than SEG_PIECE positions of a slot, so a hub slot of
// 10^5 edges is spread over thousands of lanes on every SM instead of one
// thread walking it alone; a second pass, one warp per slot cut into
// several pieces, loads the partials 32 at a time and adds them in piece
// order.  What stays serial is that chain of register adds (about 1,500 for
// the largest hub of rmat(22,16)).  The gathers of x rows are random (a 32 B
// sector for 4-8 useful bytes when x exceeds L2), which is where the time
// above the byte bound goes.  The f32 order is the one segment_sum.cu uses
// for the unfused plan, so the two plans agree bit for bit.
//
// Encoded rows (X_ROWS): the reference's have_scale body (_make_kernel :246,
// _spread_scale_tile :233) dequantizes whole gathered tiles in VMEM.  Here x
// holds X_T elements (bf16, or a narrow-resident int8 / int16 / fp8 payload)
// and, under HAVE_SCALE, an int8 scale plane with one exponent per 32 rows
// of a partition and column.  Each used endpoint row is loaded into DX
// registers, converted exactly to f32 and, under HAVE_SCALE, multiplied by
// 2^e built from its exponent bits (exact for e in [-126, 126]; exp2f need
// not be).  The UDF then runs on the registers, so the kernel on (payload,
// scale) equals the kernel on the decoded f32 rows bit for bit.  Per live
// edge the row gathers shrink to sizeof(X_T) bytes a column plus one
// exponent byte a column.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "segorder.cuh"

//@GENERATED@

struct TripletOp {
  static __device__ __forceinline__ float ident() { return IDENT; }
  static __device__ __forceinline__ float op(float a, float b) {
    return REDUCE(a, b);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(signed char v) { return (float)v; }
__device__ __forceinline__ float to_f32(short v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) {
  return static_cast<float>(v);
}

// 2^e for an int8 exponent e in [-126, 126], from its bits
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

struct TripletStage {
  const X_T* x;
  const signed char* xscale;
  long long dx;
  const float* ev;
  long long de;
  const int* src_slot;
  const int* dst_slot;
  const unsigned char* live;
  const int* perm;
  int v_mir, e_blk;

  __device__ __forceinline__ bool operator()(int q, int pos,
                                             float* msg) const {
    const long long ebase = (long long)q * e_blk;
    const long long e = ebase + (PERMUTED ? __ldg(perm + ebase + pos) : pos);
    if (!__ldg(live + e)) return false;
#if X_ROWS
    float xs[DX], xd[DX];
    if (USE_SRC) load_row(q, __ldg(src_slot + e), xs);
    if (USE_DST) load_row(q, __ldg(dst_slot + e), xd);
    udf_msg(xs, ev + e * de, xd, msg);
#else
    const float* xq = x + (long long)q * v_mir * dx;
    const float* xs =
        USE_SRC ? xq + (long long)__ldg(src_slot + e) * dx : nullptr;
    const float* xd =
        USE_DST ? xq + (long long)__ldg(dst_slot + e) * dx : nullptr;
    udf_msg(xs, ev + e * de, xd, msg);
#endif
    return true;
  }

#if X_ROWS
  // row `slot` of partition q as DX exact f32 values
  __device__ __forceinline__ void load_row(int q, int slot, float* r) const {
    const X_T* xr = x + ((long long)q * v_mir + slot) * DX;
#if HAVE_SCALE
    const signed char* sr =
        xscale + ((long long)q * ((v_mir + 31) >> 5) + (slot >> 5)) * DX;
#endif
#pragma unroll
    for (int c = 0; c < DX; ++c) {
      float v = to_f32(xr[c]);
#if HAVE_SCALE
      v *= pow2i(sr[c]);
#endif
      r[c] = v;
    }
  }
#endif
};

using Shape = SegShape<DM>;

extern "C" __global__ void __launch_bounds__(Shape::WARPS * 32)
    triplet_pieces(TripletStage st, const int* __restrict__ ptr,
                   const int* __restrict__ pptr, const int* __restrict__ pseg,
                   int np, long long n_warps, float* __restrict__ out,
                   float* __restrict__ cnt, float* __restrict__ part,
                   int* __restrict__ part_cnt) {
  __shared__ float sm[Shape::WARPS][Shape::WIN * DM];
  __shared__ unsigned char sl[Shape::WARPS][Shape::WIN];
  const int w = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * Shape::WARPS + w;
  if (gw >= n_warps) return;
  seg_pieces<DM, TripletOp>(st, ptr, pptr, pseg, st.v_mir, np, gw, out, cnt,
                            DM, part, part_cnt, sm[w], sl[w]);
}

extern "C" __global__ void triplet_combine(
    const int* __restrict__ multi, int nm, const int* __restrict__ pptr,
    int v_mir, int np, float* __restrict__ out, float* __restrict__ cnt,
    const float* __restrict__ part, const int* __restrict__ part_cnt) {
  seg_combine<TripletOp>(
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5, multi, nm, DM,
      pptr, v_mir, np, out, cnt, DM, part, part_cnt);
}

extern "C" int launch(const void* x, const void* xscale, long long dx,
                      const void* ev,
                      long long de, const void* src_slot,
                      const void* dst_slot, const void* live,
                      const void* ptr, const void* perm, const void* pptr,
                      const void* pseg, const void* multi, int nl, int v_mir,
                      int e_blk, int np, int nm, void* out, void* cnt,
                      void* part, void* part_cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  TripletStage st{(const X_T*)x, (const signed char*)xscale, dx,
                  (const float*)ev, de,
                  (const int*)src_slot, (const int*)dst_slot,
                  (const unsigned char*)live, (const int*)perm, v_mir,
                  e_blk};
  const long long n_warps = (long long)nl * (np / 32);
  const long long blocks = (n_warps + Shape::WARPS - 1) / Shape::WARPS;
  if (blocks > 0)
    triplet_pieces<<<(unsigned)blocks, Shape::WARPS * 32, 0, s>>>(
        st, (const int*)ptr, (const int*)pptr, (const int*)pseg, np, n_warps,
        (float*)out, (float*)cnt, (float*)part, (int*)part_cnt);
  if (nm > 0)
    triplet_combine<<<(unsigned)((nm + 7) / 8), 256, 0, s>>>(
        (const int*)multi, nm, (const int*)pptr, v_mir, np, (float*)out,
        (float*)cnt, (const float*)part, (const int*)part_cnt);
  return (int)cudaGetLastError();
}
