// GQA flash attention forward: online softmax over KV tiles, causal
// diagonal shifted by kv_offset, KV padding masked by bound, bf16 or f32
// inputs, f32 accumulation, output in the input dtype.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention
// (pallas_call at :121, body _kernel :30-81).
//
// Semantics kept from the Pallas kernel: q is scaled in f32 before the dot
// product; masked logits take the finite _NEG_BIG = -0.7 * FLT_MAX; p is
// exactly 0 on masked lanes (a fully masked tile leaves the running max at
// _NEG_BIG, where exp(s - m) would be 1); a row whose l stays 0 (every key
// masked) writes 0.
//
// Bound: at the serve shape (Lq = 1, non-causal) memory — the K and V bytes
// dominate, 2 * B * Hkv * Lk * Dh elements read once; at prefill shapes the
// 4 * B * Hq * Lq * Lk * Dh operations (halved when causal) on the bf16
// tensor cores.
//
// Design: the TPU grid walked (batch*head, q block, kv block) in order and
// carried m/l/acc in VMEM across the kv axis.  Here one CTA owns (batch,
// KV head, query tile) and walks the KV tiles itself, so the `group` query
// heads that share a KV head read each K/V tile from device memory once,
// through shared memory.  The CTA's rows are (head in group, query position)
// pairs: R = group * tq rows with tq = max(1, 32 / group) query positions,
// so a decode step (Lq = 1) takes a CTA of `group` rows and not a 64-row
// tile that would be 63/64 padding.  Each warp owns four rows (registers
// hold their m, l and a 4-column slice of acc per lane) and KS warps share
// a row quad by splitting every KV tile's keys (BK = 32 * KS keys, one per
// lane): a bf16 decode CTA still has eight warps loading tiles, and the KS
// partial softmax states merge through shared memory at the end.  Tiles
// wholly above the causal diagonal of the CTA's last row are never loaded;
// keys >= Lk are masked by bound, so nothing is padded or copied.  The dot
// products run on the CUDA cores in f32 with explicit fmaf (the build has
// --fmad=false); wgmma and TMA are left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>

#define NEG_BIG (-0.7f * FLT_MAX)

// Row stride of the K/V tiles in elements: an odd number of 4-byte words,
// so the 32 lanes reading 32 different keys hit 32 different banks.
__host__ __device__ constexpr int tile_stride(int dh, int elem) {
  return dh + 4 / elem;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             int hq, int hkv, int lq, int lk, int dh,
                             float scale, int causal, int kv_offset, int tq,
                             int n_rq, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = hq / hkv;
  const int rows = n_rq * 4;
  const int bk = 32 * ks;
  const int stride = tile_stride(dh, (int)sizeof(T));
  float* qs = reinterpret_cast<float*>(smem);                 // [rows][dh]
  T* kt = reinterpret_cast<T*>(qs + rows * dh);               // [bk][stride]
  T* vt = kt + bk * stride;                                   // [bk][stride]
  float* merge = reinterpret_cast<float*>(vt + bk * stride);  // [ks][rows][dh+2]

  const int b = blockIdx.z, hk = blockIdx.y, qt = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int rq = warp / ks, kw = warp % ks;

  // row r of the CTA: head hk*group + r / tq, query position qt*tq + r % tq
  auto row_head = [&](int r) { return hk * group + r / tq; };
  auto row_pos = [&](int r) { return qt * tq + r % tq; };
  auto row_live = [&](int r) { return r < group * tq && row_pos(r) < lq; };

  // stage the scaled query rows in f32
  for (int e = tid; e < rows * dh; e += nthreads) {
    const int r = e / dh, d = e % dh;
    float x = 0.0f;
    if (row_live(r)) {
      const long long off =
          (((long long)b * hq + row_head(r)) * lq + row_pos(r)) * dh + d;
      x = to_f32(q[off]) * scale;
    }
    qs[e] = x;
  }

  // KV range this CTA needs: causal rows see cols <= pos + kv_offset
  const int last_pos = min(lq - 1, qt * tq + tq - 1);
  int kv_end = lk;
  if (causal) kv_end = min(lk, last_pos + kv_offset + 1);

  float m[4], l[4], acc[4][4];
  int pos[4];
  bool live[4];
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.0f;
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    const int r = rq * 4 + i;
    live[i] = row_live(r);
    pos[i] = row_pos(r);
  }
  const int d0 = lane * 4;  // this lane's 4 output columns
  const long long kv_base = ((long long)b * hkv + hk) * lk * dh;
  const int vec = 16 / (int)sizeof(T);  // elements per 16-byte load

  for (int j0 = 0; j0 < kv_end; j0 += bk) {
    __syncthreads();  // previous tile fully consumed (and qs staged)
    const int chunks = bk * (dh / vec);
    for (int c = tid; c < chunks; c += nthreads) {
      const int j = c / (dh / vec), d = (c % (dh / vec)) * vec;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (j0 + j < lk) {
        const long long off = kv_base + (long long)(j0 + j) * dh + d;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      // the padded rows are 4-byte aligned only: store word by word
      unsigned* kd = reinterpret_cast<unsigned*>(kt + j * stride + d);
      unsigned* vd = reinterpret_cast<unsigned*>(vt + j * stride + d);
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
    __syncthreads();

    // scores of this lane's key for the warp's four rows
    const int jl = kw * 32 + lane;  // key within the tile
    const int j = j0 + jl;
    const T* krow = kt + jl * stride;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = 0; d < dh; d += 4) {
      float kd[4];
      for (int c = 0; c < 4; ++c) kd[c] = to_f32(krow[d + c]);
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (rq * 4 + i) * dh + d);
        s[i] = fmaf(qv.x, kd[0], s[i]);
        s[i] = fmaf(qv.y, kd[1], s[i]);
        s[i] = fmaf(qv.z, kd[2], s[i]);
        s[i] = fmaf(qv.w, kd[3], s[i]);
      }
    }
    float p[4];
    for (int i = 0; i < 4; ++i) {
      const bool ok = live[i] && j < lk && (!causal || j <= pos[i] + kv_offset);
      const float si = ok ? s[i] : NEG_BIG;
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = ok ? expf(si - m_new) : 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    // acc += p @ V over this warp's 32 keys
    for (int jj = 0; jj < 32; ++jj) {
      const T* vrow = vt + (kw * 32 + jj) * stride + d0;
      float vd[4];
      for (int c = 0; c < 4; ++c) vd[c] = d0 + c < dh ? to_f32(vrow[c]) : 0.0f;
      for (int i = 0; i < 4; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj);
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(pj, vd[c], acc[i][c]);
      }
    }
  }

  // merge the ks partial states of each row quad, then write
  const int mw = dh + 2;
  for (int i = 0; i < 4; ++i) {
    float* slot = merge + ((long long)kw * rows + rq * 4 + i) * mw;
    for (int c = 0; c < 4; ++c)
      if (d0 + c < dh) slot[d0 + c] = acc[i][c];
    if (lane == 0) {
      slot[dh] = m[i];
      slot[dh + 1] = l[i];
    }
  }
  __syncthreads();
  if (kw != 0) return;
  for (int i = 0; i < 4; ++i) {
    const int r = rq * 4 + i;
    if (!live[i]) continue;
    float mx = NEG_BIG;
    for (int w = 0; w < ks; ++w) mx = fmaxf(mx, merge[((long long)w * rows + r) * mw + dh]);
    float lsum = 0.0f, out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < ks; ++w) {
      const float* slot = merge + ((long long)w * rows + r) * mw;
      const float f = expf(slot[dh] - mx);
      lsum = fmaf(slot[dh + 1], f, lsum);
      for (int c = 0; c < 4; ++c)
        if (d0 + c < dh) out[c] = fmaf(slot[d0 + c], f, out[c]);
    }
    const float denom = lsum == 0.0f ? 1.0f : lsum;
    const long long off =
        (((long long)b * hq + row_head(r)) * lq + pos[i]) * dh;
    for (int c = 0; c < 4; ++c)
      if (d0 + c < dh) store(o + off + d0 + c, out[c] / denom);
  }
}

// dtype: 0 = f32, 1 = bf16.  smem: the CTA's dynamic shared memory, as
// kernels/flash_attention.py:smem_bytes lays it out (query rows, K and V
// tiles of tile_stride, merge area).  Returns the cudaError_t of the launch.
extern "C" int launch(const void* q, const void* k, const void* v, void* o,
                      int dtype, int b, int hq, int hkv, int lq, int lk, int dh,
                      float scale, int causal, int kv_offset, int tq, int n_rq,
                      int ks, int smem, void* stream) {
  const dim3 grid((lq + tq - 1) / tq, hkv, b);
  const dim3 block(32 * n_rq * ks);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    cudaFuncSetAttribute(flash_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, hq, hkv, lq, lk, dh, scale,
        causal, kv_offset, tq, n_rq, ks);
  } else {
    cudaFuncSetAttribute(flash_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_kernel<float><<<grid, block, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
        lq, lk, dh, scale, causal, kv_offset, tq, n_rq, ks);
  }
  return (int)cudaGetLastError();
}
