// CSR segment sum with f32 accumulation (the unfused plan's float-sum
// aggregation of materialised edge messages).
//
// Replaces: src/repro/kernels/segment_sum.py:segment_sum (pallas_call at
// :101, body _kernel :36).
//
// Bound: bytes.  It reads the live byte and every live message (4 B a
// column) of each CSR position once, and writes the [nl * V, D] result.
//
// Design: the TPU kernel summed one-hot matmuls over a (vertex-block,
// edge-block) grid with band skipping.  Here the messages arrive in the
// aggregation side's CSR order, so the graph's row pointers (agg_ptr) and
// their piece tables give each segment its range.  The walk and the
// combine are those of segorder.cuh (inlined below), the same code the
// fused triplet kernel runs: a warp stages 32 pieces' span of messages and
// live bytes into shared memory with coalesced reads, each lane sums its
// piece of at most SEG_PIECE positions in ascending order, skipping dead
// entries, and a second pass adds the partials of the segments cut into
// several pieces in piece order.  Same pieces, same order: it is bit-equal
// to the fused triplet kernel's sum over the same messages, and no thread
// walks a hub segment alone.  One column per grid row (blockIdx.y).
#include <cuda_runtime.h>

#include "segorder.cuh"

struct SumOp {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float op(float a, float b) {
    return a + b;
  }
};

struct MsgStage {
  const float* msgs;
  const unsigned char* live;
  int d, col, e_blk;

  __device__ __forceinline__ bool operator()(int q, int pos, float* m) const {
    const long long e = (long long)q * e_blk + pos;
    if (!__ldg(live + e)) return false;
    m[0] = __ldg(msgs + e * d + col);
    return true;
  }
};

using Shape = SegShape<1>;

extern "C" __global__ void __launch_bounds__(Shape::WARPS * 32)
    segment_sum_pieces(const float* __restrict__ msgs, int d,
                       const unsigned char* __restrict__ live,
                       const int* __restrict__ ptr,
                       const int* __restrict__ pptr,
                       const int* __restrict__ pseg, int v, int e_blk, int np,
                       long long n_warps, float* __restrict__ out,
                       float* __restrict__ part) {
  __shared__ float sm[Shape::WARPS][Shape::WIN];
  __shared__ unsigned char sl[Shape::WARPS][Shape::WIN];
  const int w = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * Shape::WARPS + w;
  if (gw >= n_warps) return;
  const int col = blockIdx.y;
  const MsgStage st{msgs, live, d, col, e_blk};
  seg_pieces<1, SumOp>(st, ptr, pptr, pseg, v, np, gw, out + col, nullptr, d,
                       part + col, nullptr, sm[w], sl[w]);
}

extern "C" __global__ void segment_sum_combine(
    const int* __restrict__ multi, int nm, int d,
    const int* __restrict__ pptr, int v, int np, float* __restrict__ out,
    const float* __restrict__ part) {
  seg_combine<SumOp>(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                     multi, nm, d, pptr, v, np, out, nullptr, d, part,
                     nullptr);
}

extern "C" int launch(const void* msgs, int d, const void* live,
                      const void* ptr, const void* pptr, const void* pseg,
                      const void* multi, int nl, int v, int e_blk, int np,
                      int nm, void* out, void* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_warps = (long long)nl * (np / 32);
  const long long blocks = (n_warps + Shape::WARPS - 1) / Shape::WARPS;
  if (blocks > 0 && d > 0)
    segment_sum_pieces<<<dim3((unsigned)blocks, (unsigned)d),
                         Shape::WARPS * 32, 0, s>>>(
        (const float*)msgs, d, (const unsigned char*)live, (const int*)ptr,
        (const int*)pptr, (const int*)pseg, v, e_blk, np, n_warps,
        (float*)out, (float*)part);
  if (nm > 0 && d > 0)
    segment_sum_combine<<<(unsigned)((nm + 7) / 8), 256, 0, s>>>(
        (const int*)multi, nm, d, (const int*)pptr, v, np, (float*)out,
        (const float*)part);
  return (int)cudaGetLastError();
}
