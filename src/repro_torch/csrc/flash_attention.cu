// GQA flash attention forward for Hopper: online softmax over key tiles,
// causal diagonal shifted by kv_offset, keys past Lk masked by bound, bf16
// or f32 inputs read through their (batch, head, position) strides, f32
// sums, output in the input dtype.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention
// (pallas_call at :121, body _kernel :30-81).  Its sequential (head, q
// block, kv block) grid, which carried m/l/acc in VMEM across the kv axis,
// is not carried over: each body below walks its key range inside one CTA.
//
// Semantics kept from the Pallas kernel: masked logits take the finite
// NEG_BIG = -0.7 * FLT_MAX; p is exactly 0 on masked keys, also where every
// key of a tile or split is masked (the running max then stays NEG_BIG,
// where exp(s - m) would be 1); a row whose l stays 0 writes 0; query
// position i sees keys <= i + kv_offset; query head h reads KV head
// h / group; sums are f32.  No float atomics: the result does not depend
// on the order in which CTAs run.  Not kept: the Pallas kernel scales q in
// f32 before the dot product, and so does the CUDA-core body here; the mma
// bodies multiply the unscaled bf16 q and scale S in f32 after the exact
// products, because a q scaled in f32 would round to bf16 again on its way
// into the tensor cores (see Precision).
//
// kernels/flash_attention.py:plan picks the body by shape alone, and the
// CTA shape, splits and shared memory with it.  A CTA owns `hc` query heads
// of one KV group times `tq` query positions ("rows"), so the heads of a
// group read each K/V tile once, through shared memory.  Where the row
// tiles leave SMs without a CTA (a decode step), the keys [0, kv_end) are
// cut into splits of SK keys, the grid is (splits x row tiles, Hkv, B), and
// each CTA writes its split's partial state (acc, m, l) in f32 to a scratch
// buffer; the last CTA of the row tile to arrive (an integer counter;
// __threadfence before the atomicAdd, and that CTA resets the counter to 0)
// merges the partials in split order 0..n-1.  DH (the head dimension) is
// #defined by kernels/flash_attention.py:source.  K/V tiles stream through
// a ring of shared-memory stages (filled by the TMA unit in the mma
// bodies, by cp.async in the CUDA-core body), so loads overlap the
// products.
//
// Precision.  The f32 plain version is the reference, and each bf16 output
// must lie within one bf16 spacing of it.  The tensor cores (mma bodies)
// multiply bf16 exactly but truncate their f32 sums to the largest term
// they align, so: S = Q K^T is scaled in f32 after the exact products (by
// scale * log2(e): the softmax runs in units of log2, p = exp2(s - m)); P
// enters P V as P_TERMS = 3 bf16 terms (hi = bf16(p), then the rest, p to
// 2^-26: one term would move a small output by up to 2^-9 of the terms it
// sums); and a P V accumulation never runs over more than one tile's keys
// before it is added to O in f32 (across a whole row of keys the
// truncation is relative to the running O, not to what each key adds).
//
// Tensor-core body (flash_tc; plan's "tensor_core"): bf16, DH a multiple
// of 16, more than 16 rows; 64 rows per CTA (one warpgroup of 128
// threads).  Bound: operations, 4 B Hq Lq Lk Dh (halved when causal) at
// 989 TFLOP/s.  Q, and a 3-stage ring of 64-key K/V tiles that one thread
// asks the TMA unit for (tensor maps built per call from the strides,
// mbarriers counting the bytes), in the 128-byte swizzled layout
// (tile_off); S = Q K^T as wgmma m64n64k16 with both operands in shared
// memory, issued for tile t + 1 before the softmax of tile t so that the
// two overlap; the online softmax in registers; O += P V as wgmma with P
// from registers and V read MN-major from shared memory.  Tiles wholly
// above the shifted diagonal are never loaded; only tiles that cross it,
// Lk or the split's end are masked.  Row tiles run heaviest first.
//
// Decode body (flash_decode; plan's "decode"): bf16, DH a multiple of 16,
// at most 16 rows (the serve step: group 4 x Lq 1).  Bound: bytes (~4
// operations per byte of K/V against the card's bf16 ridge of 295).  Warps
// take 16 keys each of a 64-key tile and run mma.sync m16n8k16: S = Q K^T,
// then O^T = V^T P^T, which puts the few query rows on the n8 side of the
// product.  On the CUDA cores (flash_simt) the same step is issue-bound
// on a convert and an FMA per K/V element and row, and on the wgmma body
// its 64-row tiles are 60 rows of padding (scripts/flash_sweep.py times
// all three).
//
// CUDA-core body (flash_simt; plan's "cuda_core"): f32, and head
// dimensions that are not a multiple of 16.  Up to 16 rows, four warps,
// warp w owns rows w, w+4, w+8, w+12, over a 3-stage ring of 32-key K/V
// tiles.  Lane j scores key j of a tile for the warp's rows (q scaled in
// f32 before the product, fmaf; the build has --fmad=false), then the warp
// adds p V with the lanes over the output columns.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#ifndef DH
#error "DH (the head dimension) is defined by kernels/flash_attention.py"
#endif

#define NEG_BIG (-0.7f * FLT_MAX)
#define THREADS 128
#define STAGES 3
#define SIMT_BK 32   // keys per tile, CUDA-core body
#define TC_BN 64     // keys per tile, tensor-core body
#define TC_ROWS 64   // rows per CTA, tensor-core body
#define P_TERMS 3    // bf16 terms of P in P V (the mma bodies)

// One call's arguments, as kernels/flash_attention.py packs them.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;   // [row tiles][splits][rows][DH + 2] partial acc, m, l
  int* count;    // [row tiles] arrivals, zero between calls
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl;  // element strides
  int b, hq, hkv, lq, lk;
  float scale;
  int causal, kv_offset;
  int hc, tq, head_tiles, pos_tiles;
  int kv_end, split_keys, n_splits;
  int smem, dtype, body;  // dtype 0 f32, 1 bf16; body 0 CUDA cores, 1
                          // wgmma, 2 decode (mma.sync)
};
static_assert(sizeof(Args) == 192, "Args must match the wrapper's packing");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// n consecutive elements as f32, one vector load where n * sizeof(T) is
// 4, 8 or 16 bytes (the caller keeps them that aligned)
template <int N, typename T>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4) {
    using V = typename std::conditional<
        BYTES == 16, uint4,
        typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
    const V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0: the
// softmax's exp2(s - m) with s <= m (p of masked keys is set to 0 apart)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared without registers; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The CTA's key range: its split, cut at the causal end of its last row.
__device__ __forceinline__ void key_range(const Args& a, int split, int pt,
                                          int* lo, int* hi) {
  const int last_pos = min(a.lq - 1, pt * a.tq + a.tq - 1);
  *lo = split * a.split_keys;
  int h = min(*lo + a.split_keys, a.kv_end);
  if (a.causal) h = min(h, last_pos + a.kv_offset + 1);
  *hi = max(*lo, h);
}

// Row tile of a CTA, for the split merge's counters and partials.
__device__ __forceinline__ long long row_tile(const Args& a, int b, int hk,
                                              int pt, int ht) {
  return (((long long)b * a.hkv + hk) * a.pos_tiles + pt) * a.head_tiles + ht;
}

// After this CTA wrote its partial state: true in the last CTA of the row
// tile to arrive, which then sees every split's partial.  The barrier
// orders every thread's writes before thread 0's arrival, an integer add
// that releases them (and acquires the other CTAs') at gpu scope, as a
// fence by one thread after a barrier does in a grid-wide sync.
__device__ __forceinline__ bool arrive_last(const Args& a, long long tile) {
  __syncthreads();
  int before = 0;
  if (threadIdx.x == 0)
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(a.count + tile) : "memory");
  // no static shared memory: see flash_tc
  return __syncthreads_or(threadIdx.x == 0 && before == a.n_splits - 1);
}

// Merges row r's partial states (acc, m, l at base[part][row], rows per
// part) in part order 0..parts-1, which is key order: M = max m, L = sum
// l 2^(m - M) (e^ without LOG2), acc = sum acc 2^(m - M).  Each lane gets
// its NC columns of acc, and M and L.  GLOBAL: base is device memory that
// other CTAs wrote (read through L2), else shared memory.
template <bool LOG2, bool GLOBAL>
__device__ __forceinline__ void merge_row(const float* base, int parts,
                                          int rows, int r, float* acc,
                                          float* m_out, float* l_out) {
  constexpr int NC = (DH + 31) / 32;
  const int lane = threadIdx.x & 31;
  auto ld = [](const float* p) { return GLOBAL ? __ldcg(p) : *p; };
  auto at = [&](int sp) { return base + ((long long)sp * rows + r) * (DH + 2); };
  auto weight = [&](float m, float mx) {
    return LOG2 ? exp2f(m - mx) : expf(m - mx);
  };
  float mx = NEG_BIG, lsum = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  if (parts <= 32) {
    // lane sp loads part sp's m and l once; its weight and l's share reach
    // the warp by shuffles, and the loop below loads only acc
    const bool mine = lane < parts;
    const float m_l = mine ? ld(at(lane) + DH) : NEG_BIG;
    const float l_l = mine ? ld(at(lane) + DH + 1) : 0.0f;
    mx = warp_max(m_l);  // max is exact in any order
    const float f_l = weight(m_l, mx), lf_l = l_l * f_l;
#pragma unroll 8
    for (int sp = 0; sp < parts; ++sp) {
      const float f = __shfl_sync(0xffffffffu, f_l, sp);
      lsum = lsum + __shfl_sync(0xffffffffu, lf_l, sp);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane * NC + c;
        if (col < DH) acc[c] = acc[c] + ld(at(sp) + col) * f;
      }
    }
  } else {
    for (int s0 = 0; s0 < parts; s0 += 32) {
      const int sp = s0 + lane;
      mx = fmaxf(mx, warp_max(sp < parts ? ld(at(sp) + DH) : NEG_BIG));
    }
#pragma unroll 8
    for (int sp = 0; sp < parts; ++sp) {
      const float f = weight(ld(at(sp) + DH), mx);
      lsum = lsum + ld(at(sp) + DH + 1) * f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane * NC + c;
        if (col < DH) acc[c] = acc[c] + ld(at(sp) + col) * f;
      }
    }
  }
  *m_out = mx;
  *l_out = lsum;
}

// Writes lane's NC columns of row r of the CTA's tile: acc / l, 0 where l
// is 0.
template <typename T>
__device__ __forceinline__ void write_row(const Args& a, int b, int hk,
                                          int pt, int ht, int r,
                                          const float* acc, float l) {
  constexpr int NC = (DH + 31) / 32;
  const int lane = threadIdx.x & 31, group = a.hq / a.hkv;
  const long long off = (((long long)b * a.hq + hk * group + ht * a.hc +
                          r / a.tq) * a.lq + pt * a.tq + r % a.tq) * DH;
  const float denom = l == 0.0f ? 1.0f : l;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = lane * NC + c;
    if (col < DH) store(static_cast<T*>(a.o) + off + col, acc[c] / denom);
  }
}

__device__ __forceinline__ bool tile_row_live(const Args& a, int pt, int ht,
                                              int r) {
  return r < a.hc * a.tq && ht * a.hc + r / a.tq < a.hq / a.hkv &&
         pt * a.tq + r % a.tq < a.lq;
}

// The last CTA of a row tile merges the parts' partial states and writes
// the rows, then resets the tile's counter.  Warps take rows, lanes
// columns.  LOG2: m is in units of log2 (the mma bodies'), else of ln.
template <typename T, bool LOG2>
__device__ void merge_splits(const Args& a, const float* base, int parts,
                             long long tile, int b, int hk, int pt, int ht) {
  float acc[(DH + 31) / 32], m, l;
  for (int r = threadIdx.x >> 5; r < a.hc * a.tq; r += THREADS / 32) {
    if (!tile_row_live(a, pt, ht, r)) continue;
    merge_row<LOG2, true>(base, parts, a.hc * a.tq, r, acc, &m, &l);
    write_row<T>(a, b, hk, pt, ht, r, acc, l);
  }
  if (threadIdx.x == 0) a.count[tile] = 0;
}

// ------------------------------------------------------------ CUDA cores
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_simt(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ELEM = (int)sizeof(T);
  constexpr int VEC = 16 / ELEM;           // elements per 16-byte chunk
  constexpr int CH = DH / VEC;             // chunks per row
  constexpr int KSTRIDE = DH * ELEM + 16;  // bytes per key row of a tile:
  // 16 mod 128, so eight lanes reading 16 bytes of eight rows hit 32 banks
  constexpr int NC = (DH + 31) / 32;       // output columns per lane:
  // lane l owns columns l*NC .. l*NC + NC - 1
  constexpr int TILE = SIMT_BK * KSTRIDE;

  const int rows = a.hc * a.tq;
  float* qs = reinterpret_cast<float*>(smem);             // [rows][DH]
  unsigned char* ring = smem + rows * DH * 4;             // [STAGES][K, V]
  const int group = a.hq / a.hkv;
  const int x = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int split = x % a.n_splits;
  const int ht = (x / a.n_splits) % a.head_tiles;
  const int pt = x / (a.n_splits * a.head_tiles);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  // row r: head hk*group + ht*hc + r/tq, position pt*tq + r%tq
  auto row_head = [&](int r) { return ht * a.hc + r / a.tq; };
  auto row_pos = [&](int r) { return pt * a.tq + r % a.tq; };
  auto row_live = [&](int r) {
    return r < rows && row_head(r) < group && row_pos(r) < a.lq;
  };

  int k_lo, k_hi;
  key_range(a, split, pt, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + SIMT_BK - 1) / SIMT_BK;
  auto load_tile = [&](int t) {
    if (t < ntiles) {
      unsigned char* st = ring + (t % STAGES) * 2 * TILE;
      for (int c = tid; c < 2 * SIMT_BK * CH; c += THREADS) {
        const int which = c / (SIMT_BK * CH), rem = c % (SIMT_BK * CH);
        const int j = rem / CH, ch = rem % CH;
        const int key = k_lo + t * SIMT_BK + j;
        const bool ok = key < k_hi;
        const T* src = which ? vb + (ok ? key : 0) * a.vsl
                             : kb + (ok ? key : 0) * a.ksl;
        cp_async16(st + which * TILE + j * KSTRIDE + ch * 16, src + ch * VEC,
                   ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  // the scaled query rows in f32
  for (int e = tid; e < rows * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    float xq = 0.0f;
    if (row_live(r)) {
      const long long off = b * a.qsb +
                            (long long)(hk * group + row_head(r)) * a.qsh +
                            (long long)row_pos(r) * a.qsl + d;
      xq = to_f32(q[off]) * a.scale;
    }
    qs[e] = xq;
  }

  const int nr = max(0, min(4, (rows - warp + 3) / 4));  // this warp's rows
  float m[4], l[4], acc[4][NC];
  int pos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    live[i] = i < nr && row_live(warp + 4 * i);
    pos[i] = row_pos(warp + 4 * i);
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t (and qs) visible; tile t-1's stage is free
    load_tile(t + STAGES - 1);
    const unsigned char* kt = ring + (t % STAGES) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    const int j = k_lo + t * SIMT_BK + lane;

    // lane's key against the warp's rows, four partial sums a row
    float sp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[i][e] = 0.0f;
    const uint4* krow = reinterpret_cast<const uint4*>(kt + lane * KSTRIDE);
#pragma unroll 4
    for (int ch = 0; ch < CH; ++ch) {
      const uint4 raw = krow[ch];
      const T* kv = reinterpret_cast<const T*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = to_f32(kv[e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nr) {
          const float4* qr =
              reinterpret_cast<const float4*>(qs + (warp + 4 * i) * DH + ch * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = qr[e4];
            sp[i][0] = fmaf(qv.x, kf[4 * e4], sp[i][0]);
            sp[i][1] = fmaf(qv.y, kf[4 * e4 + 1], sp[i][1]);
            sp[i][2] = fmaf(qv.z, kf[4 * e4 + 2], sp[i][2]);
            sp[i][3] = fmaf(qv.w, kf[4 * e4 + 3], sp[i][3]);
          }
        }
      }
    }
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = (sp[i][0] + sp[i][1]) + (sp[i][2] + sp[i][3]);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = 0.0f;
      if (i < nr) {
        const bool ok = live[i] && j < k_hi &&
                        (!a.causal || j <= pos[i] + a.kv_offset);
        const float si = ok ? s[i] : NEG_BIG;
        const float m_new = fmaxf(m[i], warp_max(si));
        p[i] = ok ? expf(si - m_new) : 0.0f;
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(p[i]);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        m[i] = m_new;
      }
    }
    // acc += p V, lanes over the output columns
#pragma unroll 8
    for (int jj = 0; jj < SIMT_BK; ++jj) {
      float vd[NC];
      if (lane * NC < DH)
        load_f32<NC>(reinterpret_cast<const T*>(vt + jj * KSTRIDE) + lane * NC,
                     vd);
      else
#pragma unroll
        for (int c = 0; c < NC; ++c) vd[c] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nr) {
          const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, vd[c], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* o = static_cast<T*>(a.o);
  auto out_off = [&](int r) {
    return (((long long)blockIdx.z * a.hq + hk * group + row_head(r)) * a.lq +
            row_pos(r)) * DH;
  };
  if (a.n_splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!live[i]) continue;
      const float denom = l[i] == 0.0f ? 1.0f : l[i];
      const long long off = out_off(warp + 4 * i);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane * NC + c;
        if (col < DH) store(o + off + col, acc[i][c] / denom);
      }
    }
    return;
  }

  // several splits: write this split's partial state, count the arrival
  const long long tile = row_tile(a, b, hk, pt, ht);
  float* base = a.part + tile * a.n_splits * rows * (DH + 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= nr) continue;
    float* slot = base + ((long long)split * rows + warp + 4 * i) * (DH + 2);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane * NC + c;
      if (col < DH) slot[col] = acc[i][c];
    }
    if (lane == 0) {
      slot[DH] = m[i];
      slot[DH + 1] = l[i];
    }
  }
  if (arrive_last(a, tile))
    merge_splits<T, false>(a, base, a.n_splits, tile, b, hk, pt, ht);
}

// ---------------------------------------------------------- tensor cores
// Shared-memory matrix descriptor: start address, LBO and SBO (the byte
// strides between core matrices that desc_kmajor and desc_v name); the
// swizzle mode goes in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins a register that an asynchronous wgmma reads or writes to this point
// of the program, so that no use of it moves across wgmma.wait_group.
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A from registers, B MN-major in
// shared memory (imm-trans-b 1)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#if DH % 16 == 0
// Shared-memory layout of a 64-row tile of Q, K or V (row = query row or
// key, DH bf16 columns), the 128-byte swizzle of the wgmma descriptors:
// blocks of 64 columns, each 64 rows x 128 bytes, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8), so that the eight rows of a core
// matrix (and of an ldmatrix) fall in eight different bank groups.
constexpr int DHP = (DH + 63) / 64 * 64;  // columns with the last block padded
constexpr int TC_TILE = TC_BN * DHP * 2;  // bytes of a 64-row tile

// byte offset of 16-byte chunk `ch` of row `r` in a tile
__device__ __forceinline__ int tile_off(int r, int ch) {
  return (ch >> 3) * (64 * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// Descriptor of the K-major operand (Q, or K for S = Q K^T) at k step kk
// (columns 16kk .. 16kk + 15): SBO the next 8 rows.
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* t,
                                                int kk) {
  return gmma_desc(t + (kk >> 2) * (64 * 128) + (kk & 3) * 32, 16, 1024) |
         (1ull << 62);
}

// Descriptor of V (MN-major) at keys 16kk .. 16kk + 15, columns c0 ..:
// LBO the next 64 columns, SBO the next 8 keys.
__device__ __forceinline__ uint64_t desc_v(const unsigned char* t, int kk,
                                           int c0) {
  return gmma_desc(t + (c0 >> 6) * (64 * 128) + (c0 & 63) * 2 + kk * 2048,
                   64 * 128, 1024) | (1ull << 62);
}

// O[:, c0 : c0 + N] += P V[:, c0 : c0 + N] for 16-key step kk; the O
// columns are cut into N = 128, 64, 32, 16 (every multiple of 16 <= 128),
// each aligned to its width, so none crosses a 64-column block
template <int C0>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        const unsigned char* vt, int kk) {
  constexpr int LEFT = DH - C0;
  if constexpr (LEFT > 0) {
    constexpr int N = LEFT >= 128 ? 128 : LEFT >= 64 ? 64 : LEFT >= 32 ? 32 : 16;
    const uint64_t db = desc_v(vt, kk, C0);
    if constexpr (N == 128) wgmma_rs_n128(o + C0 / 2, a, db, 1);
    else if constexpr (N == 64) wgmma_rs_n64(o + C0 / 2, a, db, 1);
    else if constexpr (N == 32) wgmma_rs_n32(o + C0 / 2, a, db, 1);
    else wgmma_rs_n16(o + C0 / 2, a, db, 1);
    pv_step<C0 + N>(o, a, vt, kk);
  }
}

// mbarrier and TMA (cp.async.bulk.tensor) for the tensor-core body's ring
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// box (64 columns, 64 keys) of a [B, H, L, DH] tensor at (c, key, h, b)
// into shared memory, 128-byte swizzled as tile_off lays it out; keys and
// columns past the tensor's ends arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c, int key, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(tm), "r"(c), "r"(key), "r"(h), "r"(b),
         "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(THREADS)
flash_tc(const Args a, const __grid_constant__ CUtensorMap tmk,
         const __grid_constant__ CUtensorMap tmv) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = DH / 8;                   // 16-byte chunks per row
  // tiles start on 1024 bytes, the swizzle's period: the kernel has no
  // static shared memory, so its dynamic shared memory starts the CTA's
  // window, which is so aligned
  if ((uint32_t)__cvta_generic_to_shared(smem) & 1023) __trap();
  unsigned char* qs = smem;                    // [64 rows][DHP]
  unsigned char* ring = qs + TC_TILE;          // [STAGES][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TC_TILE);

  const int group = a.hq / a.hkv;
  const int split = blockIdx.x % a.n_splits;
  const int ht = (blockIdx.x / a.n_splits) % a.head_tiles;
  const int pt = a.pos_tiles - 1 - (int)blockIdx.x / (a.n_splits * a.head_tiles);
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = a.hc * a.tq;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  auto row_live = [&](int r) {
    return r < rows && ht * a.hc + r / a.tq < group &&
           pt * a.tq + r % a.tq < a.lq;
  };

  // Q, zeros on rows past the tile
  for (int c = tid; c < TC_ROWS * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = row_live(r);
    const __nv_bfloat16* src = q;
    if (ok)
      src = q + b * a.qsb +
            (long long)(hk * group + ht * a.hc + r / a.tq) * a.qsh +
            (long long)(pt * a.tq + r % a.tq) * a.qsl + ch * 8;
    cp_async16(qs + tile_off(r, ch), src, ok);
  }
  cp_async_commit();

  int k_lo, k_hi;
  key_range(a, split, pt, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TC_BN - 1) / TC_BN;
  // one thread asks the TMA unit for each K/V tile: 64 keys from k_lo +
  // 64t, every column block, into stage t % STAGES, whose mbarrier counts
  // the bytes; keys past k_hi (another split's, or past the causal end)
  // are masked like any other
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int t) {
    if (tid == 0 && t < ntiles) {
      unsigned char* st = ring + (t % STAGES) * 2 * TC_TILE;
      mbar_expect_tx(&full[t % STAGES], 2 * TC_TILE);
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(st + cb * 64 * 128, &tmk, 64 * cb, k_lo + t * TC_BN, hk, b,
                 &full[t % STAGES]);
        tma_load(st + TC_TILE + cb * 64 * 128, &tmv, 64 * cb,
                 k_lo + t * TC_BN, hk, b, &full[t % STAGES]);
      }
    }
  };
  for (int t = 0; t < STAGES; ++t) load_tile(t);
  cp_async_wait<0>();   // Q
  fence_proxy_async();

  // this thread's two rows (wgmma accumulator layout) and four key columns
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool live0 = row_live(r0), live1 = row_live(r1);
  const int pos0 = pt * a.tq + r0 % a.tq, pos1 = pt * a.tq + r1 % a.tq;
  const int first_pos = pt * a.tq;
  // the softmax runs in units of log2: s = (q k) * scale * log2(e), so that
  // p = exp2(s - m) is one MUFU.EX2
  const float scale2 = a.scale * 1.4426950408889634f;
  // a warp whose 16 rows are all past the tile's rows skips the softmax:
  // its P is 0
  const bool warp_rows = warp * 16 < rows;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.0f, l1 = 0.0f;

  // S of tile t into acc, issued and committed, not waited for
  auto issue_s = [&](float* acc, int t) {
    const unsigned char* kt = ring + (t % STAGES) * 2 * TC_TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(acc, desc_kmajor(qs, kk), desc_kmajor(kt, kk), 1);
    wgmma_commit();
  };
  float s[32], sn[32];
  __syncthreads();  // Q visible to every warp's wgmma
  if (ntiles > 0) {
    mbar_wait(&full[0], 0);
    issue_s(s, 0);
    wgmma_wait0();
  }

  for (int t = 0; t < ntiles; ++t) {
    const unsigned char* vt = ring + (t % STAGES) * 2 * TC_TILE + TC_TILE;
    // the tensor cores compute S of tile t + 1 while this softmax runs
    if (t + 1 < ntiles) {
      mbar_wait(&full[(t + 1) % STAGES], ((t + 1) / STAGES) & 1);
      issue_s(sn, t + 1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(s[i]);

    // s[4n + e] is (r0, key 8n + 2 t4 + e), s[4n + 2 + e] is (r1, ...);
    // keys past k_hi belong to the next split or past Lk
    const int j0 = k_lo + t * TC_BN;
    uint32_t pa[P_TERMS][4][4];
    float alpha0 = 1.0f, alpha1 = 1.0f;
    if (warp_rows) {
      const bool edge = j0 + TC_BN > k_hi ||
                        (a.causal && j0 + TC_BN - 1 > first_pos + a.kv_offset);
      uint32_t okbits = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = j0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          const bool hi_row = (i & 2) != 0;
          const bool ok =
              (hi_row ? live1 : live0) && j < k_hi &&
              (!a.causal || j <= (hi_row ? pos1 : pos0) + a.kv_offset);
          if (!ok) {
            okbits &= ~(1u << i);
            s[i] = NEG_BIG;
          }
        }
      }
      // row maxima as trees: s[4n + e] is row r0 for e < 2, r1 else
      float t0[8], t1[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        t0[n] = fmaxf(s[4 * n], s[4 * n + 1]);
        t1[n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
      }
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int n = 0; n < w; ++n) {
          t0[n] = fmaxf(t0[n], t0[n + w]);
          t1[n] = fmaxf(t1[n], t1[n + w]);
        }
      float mx0 = fmaxf(m0, t0[0]), mx1 = fmaxf(m1, t1[0]);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      alpha0 = ex2(m0 - mx0);
      alpha1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = (okbits >> i) & 1u ? ex2(s[i] - ((i & 2) ? mx1 : mx0)) : 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        t0[n] = s[4 * n] + s[4 * n + 1];
        t1[n] = s[4 * n + 2] + s[4 * n + 3];
      }
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int n = 0; n < w; ++n) {
          t0[n] += t0[n + w];
          t1[n] += t1[n + w];
        }
      const float sum0 = t0[0], sum1 = t1[0];
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
      // P as A fragments: 16-key step kk takes p[8kk .. 8kk + 7] in pairs,
      // in P_TERMS bf16 terms: term 0 = bf16(p), term n = bf16(p - terms <n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float2 x = make_float2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
          for (int n = 0; n < P_TERMS; ++n) {
            const __nv_bfloat162 h = __float22bfloat162_rn(x);
            pa[n][kk][r] = *reinterpret_cast<const uint32_t*>(&h);
            const float2 hf = __bfloat1622float2(h);
            x.x -= hf.x;
            x.y -= hf.y;
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < P_TERMS; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[n][kk][r] = 0u;
    }

    // this tile's P V in an accumulator of its own (the tensor cores
    // truncate the f32 sums they align to their largest term; a fresh
    // accumulator keeps that to the tile's size), then O = alpha O + P V
    // in f32, rounded to nearest
    float ot[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) ot[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < P_TERMS; ++n) pv_step<0>(ot, pa[n][kk], vt, kk);
    wgmma_commit();
    wgmma_wait0();  // P V of tile t, and S of tile t + 1
#pragma unroll
    for (int n = 0; n < P_TERMS; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_reg(pa[n][kk][r]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      fence_reg(ot[i]);
      o[i] = fmaf(o[i], (i & 2) ? alpha1 : alpha0, ot[i]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(sn[i]);
      s[i] = sn[i];
    }
    __syncthreads();  // every warp is past tile t: its stage is free
    load_tile(t + STAGES);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (a.n_splits > 1) {  // write this split's partial state
    const long long tile = row_tile(a, b, hk, pt, ht);
    float* base = a.part + tile * a.n_splits * rows * (DH + 2);
    float* slot0 = base + ((long long)split * rows + r0) * (DH + 2);
    float* slot1 = base + ((long long)split * rows + r1) * (DH + 2);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (r0 < rows) {
        slot0[col] = o[4 * n];
        slot0[col + 1] = o[4 * n + 1];
      }
      if (r1 < rows) {
        slot1[col] = o[4 * n + 2];
        slot1[col + 1] = o[4 * n + 3];
      }
    }
    if (t4 == 0 && r0 < rows) {
      slot0[DH] = m0;
      slot0[DH + 1] = l0;
    }
    if (t4 == 0 && r1 < rows) {
      slot1[DH] = m1;
      slot1[DH + 1] = l1;
    }
    if (arrive_last(a, tile))
      merge_splits<__nv_bfloat16, true>(a, base, a.n_splits, tile, b, hk, pt,
                                        ht);
    return;
  }
  const float d0 = l0 == 0.0f ? 1.0f : l0, d1 = l1 == 0.0f ? 1.0f : l1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  const long long head0 = (long long)b * a.hq + hk * group + ht * a.hc;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    if (live0) {
      const long long off = ((head0 + r0 / a.tq) * a.lq + pos0) * DH + col;
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(o[4 * n] / d0, o[4 * n + 1] / d0);
    }
    if (live1) {
      const long long off = ((head0 + r1 / a.tq) * a.lq + pos1) * DH + col;
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
  }
}

// ------------------------------------------------------ decode (mma.sync)
#define DEC_STAGES 2  // 64-key K/V tiles in the decode body's ring

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Decode body: one m16 tile of rows (zeros past group x Lq) that every
// warp holds.  The split's keys stream through a DEC_STAGES ring of 64-key
// K/V tiles (TMA, the tile_off layout, so that ldmatrix's eight rows hit
// eight bank groups); warp w takes keys 16w .. 16w + 15 of each tile:
// S = Q K^T (Q and K by ldmatrix), the online softmax on the accumulator
// fragments, and O^T += V^T P^T (V^T by ldmatrix.trans; P^T's B fragments
// are the accumulator's own registers, in P_TERMS bf16 terms).  Each warp
// keeps its own (O, m, l); the four merge through shared memory in warp
// order into the split's state.  NT: query-row n-tiles of 8 (rows <= 8
// NT).  Three CTAs an SM (68 KB of shared memory each): at most 168
// registers.
template <int NT>
__global__ void __launch_bounds__(THREADS, 3)
flash_decode(const Args a, const __grid_constant__ CUtensorMap tmk,
             const __grid_constant__ CUtensorMap tmv) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  // the swizzled tiles start on 1024 bytes (no static shared memory)
  if ((uint32_t)__cvta_generic_to_shared(smem) & 1023) __trap();
  if (threadIdx.x == 0) {  // the tensor maps, ahead of the first TMA load
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmk) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmv) : "memory");
  }
  const int group = a.hq / a.hkv;
  const int split = blockIdx.x % a.n_splits;
  const int ht = (blockIdx.x / a.n_splits) % a.head_tiles;
  const int pt = blockIdx.x / (a.n_splits * a.head_tiles);
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = a.hc * a.tq;
  auto row_live = [&](int r) {
    return r < rows && ht * a.hc + r / a.tq < group &&
           pt * a.tq + r % a.tq < a.lq;
  };

  // Q (16 rows, unscaled bf16, zeros on dead rows) after the K/V ring, in
  // the same swizzle with 16-row blocks; read back by ldmatrix as the A
  // operand at every tile; then the ring's mbarriers
  unsigned char* qs = smem + DEC_STAGES * 2 * TC_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + 16 * DHP * 2);
  auto q_off = [](int r, int ch) {
    return (ch >> 3) * (16 * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  };
  for (int c = tid; c < 16 * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = row_live(r);
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.q);
    if (ok)
      src += b * a.qsb +
             (long long)(hk * group + ht * a.hc + r / a.tq) * a.qsh +
             (long long)(pt * a.tq + r % a.tq) * a.qsl + ch * 8;
    cp_async16(qs + q_off(r, ch), src, ok);
  }
  cp_async_commit();

  int k_lo, k_hi;
  key_range(a, split, pt, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TC_BN - 1) / TC_BN;
  // one thread asks the TMA unit for each K/V tile (as in flash_tc)
  if (tid == 0) {
    for (int s = 0; s < DEC_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int t) {
    if (tid == 0 && t < ntiles) {
      unsigned char* st = smem + (t % DEC_STAGES) * 2 * TC_TILE;
      mbar_expect_tx(&full[t % DEC_STAGES], 2 * TC_TILE);
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(st + cb * 64 * 128, &tmk, 64 * cb, k_lo + t * TC_BN, hk, b,
                 &full[t % DEC_STAGES]);
        tma_load(st + TC_TILE + cb * 64 * 128, &tmv, 64 * cb,
                 k_lo + t * TC_BN, hk, b, &full[t % DEC_STAGES]);
      }
    }
  };
  // every stage in flight from the start: a split has only a few tiles,
  // and each refill waits for the tile before it to be consumed
  for (int t = 0; t < DEC_STAGES; ++t) load_tile(t);
  cp_async_wait<0>();  // Q
  __syncthreads();     // Q visible to every warp

  const int r0 = g, r1 = g + 8;
  const bool live0 = row_live(r0), live1 = row_live(r1);
  const int pos0 = pt * a.tq + r0 % a.tq, pos1 = pt * a.tq + r1 % a.tq;
  const float scale2 = a.scale * 1.4426950408889634f;

  // O^T = V^T P^T, so that the query rows are the n8 side of the product
  // and a decode step's few rows waste little of it: o[nt][m] holds
  // (column 16m + g (+8 for e >= 2), row 8nt + 2t4 + e % 2)
  float o[NT][DH / 16][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < DH / 16; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][m][e] = 0.0f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.0f, l1 = 0.0f;
  const int kw = 16 * warp;  // this warp's keys in a tile

  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&full[t % DEC_STAGES], (t / DEC_STAGES) & 1);  // tile t
    const unsigned char* kt = smem + (t % DEC_STAGES) * 2 * TC_TILE;
    const unsigned char* vt = kt + TC_TILE;

    // S: sc[n][e] is (row g or g + 8, key kw + 8n + 2t4 + e % 2)
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], kf[4];  // Q rows 0-15; K^T of keys kw .., kw + 8 ..
      ldsm_x4(qa, qs + q_off((lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * kk + (lane >> 4)));
      ldsm_x4(kf, kt + tile_off(kw + (lane >> 4) * 8 + (lane & 7),
                                2 * kk + ((lane >> 3) & 1)));
      mma16816(sc[0], qa, kf[0], kf[1]);
      mma16816(sc[1], qa, kf[2], kf[3]);
    }

    const int j0 = k_lo + t * TC_BN + kw;
    const bool edge = j0 + 16 > k_hi ||
                      (a.causal && j0 + 15 > pt * a.tq + a.kv_offset);
    float mx0 = m0, mx1 = m1;
    uint32_t okbits = 0xffu;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float& x = sc[i >> 2][i & 3];
      x *= scale2;
      if (edge) {
        const int j = j0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const bool hi = (i & 2) != 0;
        const bool ok = (hi ? live1 : live0) && j < k_hi &&
                        (!a.causal || j <= (hi ? pos1 : pos0) + a.kv_offset);
        if (!ok) {
          okbits &= ~(1u << i);
          x = NEG_BIG;
        }
      }
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float& x = sc[i >> 2][i & 3];
      x = (okbits >> i) & 1u ? ex2(x - ((i & 2) ? mx1 : mx0)) : 0.0f;
      if (i & 2) sum1 += x;
      else sum0 += x;
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    // O^T's columns are rows 8nt + 2t4 and + 1: their alpha lives in the
    // lanes with g = 2t4 and 2t4 + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float al = nt ? alpha1 : alpha0;
      const float al_a = __shfl_sync(0xffffffffu, al, 8 * t4);
      const float al_b = __shfl_sync(0xffffffffu, al, 8 * t4 + 4);
#pragma unroll
      for (int m = 0; m < DH / 16; ++m) {
        o[nt][m][0] *= al_a;
        o[nt][m][1] *= al_b;
        o[nt][m][2] *= al_a;
        o[nt][m][3] *= al_b;
      }
    }

    // P^T as the B operand of the 16-key step, as the accumulator holds it:
    // n-tile nt is rows 8nt + g, b0 its keys 2t4 (+1), b1 keys 8 + 2t4 (+1)
    uint32_t pb[P_TERMS][NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 xv = make_float2(sc[h][2 * nt], sc[h][2 * nt + 1]);
#pragma unroll
        for (int n = 0; n < P_TERMS; ++n) {
          const __nv_bfloat162 hv = __float22bfloat162_rn(xv);
          pb[n][nt][h] = *reinterpret_cast<const uint32_t*>(&hv);
          const float2 hf = __bfloat1622float2(hv);
          xv.x -= hf.x;
          xv.y -= hf.y;
        }
      }
    }
    // O^T += V^T P^T: V^T of columns 16m .. 16m + 15 by ldmatrix.trans
#pragma unroll
    for (int m = 0; m < DH / 16; ++m) {
      uint32_t va[4];
      ldsm_x4_t(va, vt + tile_off(kw + (lane >> 4) * 8 + (lane & 7),
                                  2 * m + ((lane >> 3) & 1)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int n = 0; n < P_TERMS; ++n)
          mma16816(o[nt][m], va, pb[n][nt][0], pb[n][nt][1]);
    }
    __syncthreads();  // every warp is done with tile t's stage
    load_tile(t + DEC_STAGES);
  }

  // the four warps' states in shared memory (the ring is free), merged in
  // warp order, which is key order, into the split's state
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();
  float* ws = reinterpret_cast<float*>(smem);  // [warp][16 rows][DH + 2]
  float* w0 = ws + (warp * 16 + r0) * (DH + 2);
  float* w1 = ws + (warp * 16 + r1) * (DH + 2);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* wa = ws + (warp * 16 + 8 * nt + 2 * t4) * (DH + 2);
    float* wb = wa + (DH + 2);
#pragma unroll
    for (int m = 0; m < DH / 16; ++m) {
      wa[16 * m + g] = o[nt][m][0];
      wb[16 * m + g] = o[nt][m][1];
      wa[16 * m + g + 8] = o[nt][m][2];
      wb[16 * m + g + 8] = o[nt][m][3];
    }
  }
  if (t4 == 0) {
    w0[DH] = m0;
    w0[DH + 1] = l0;
    w1[DH] = m1;
    w1[DH + 1] = l1;
  }
  __syncthreads();
  const long long tile = row_tile(a, b, hk, pt, ht);
  float* base = a.part + tile * a.n_splits * rows * (DH + 2);
  constexpr int NC = (DH + 31) / 32;
  float acc[NC], m, l;
  for (int r = warp; r < rows; r += THREADS / 32) {
    merge_row<true, false>(ws, THREADS / 32, 16, r, acc, &m, &l);
    if (a.n_splits == 1) {
      if (row_live(r)) write_row<__nv_bfloat16>(a, b, hk, pt, ht, r, acc, l);
      continue;
    }
    float* slot = base + ((long long)split * rows + r) * (DH + 2);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane * NC + c < DH) slot[lane * NC + c] = acc[c];
    if (lane == 0) {
      slot[DH] = m;
      slot[DH + 1] = l;
    }
  }
  if (a.n_splits > 1 && arrive_last(a, tile))
    merge_splits<__nv_bfloat16, true>(a, base, a.n_splits, tile, b, hk, pt,
                                      ht);
}

#endif  // DH % 16 == 0

// Launches the body a->body chose with a->smem bytes of dynamic shared
// memory on `stream`; grid as kernels/flash_attention.py:plan lays it out.
// Returns the cudaError_t of the launch.
template <typename K>
static void allow_smem(K kernel, int smem, int* allowed) {
  if (smem > *allowed) {  // once per kernel and size, not every call
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    // all of the SM's 228 KB as shared memory, so that as many CTAs fit
    // as their shared memory allows (the L1 share is of no use here)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    *allowed = smem;
  }
}

#if DH % 16 == 0
// TMA descriptor of K or V ([B, Hkv, Lk, DH] bf16 with element strides sl,
// sh, sb): boxes of 64 columns x 64 keys, 128-byte swizzle.  The driver's
// encoder comes through the runtime (the library links no -lcuda).  A
// dimension of size 1 gets a stride of 16 bytes: it is never stepped.
static int tensor_map(CUtensorMap* tm, const void* base, const Args& a,
                      long long sl, long long sh, long long sb) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return e != cudaSuccess ? (int)e : (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)a.lk,
                              (cuuint64_t)a.hkv, (cuuint64_t)a.b};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(a.lk > 1 ? sl * 2 : 16), (cuuint64_t)(a.hkv > 1 ? sh * 2 : 16),
      (cuuint64_t)(a.b > 1 ? sb * 2 : 16)};
  const cuuint32_t box[4] = {64, TC_BN, 1, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
#endif

extern "C" int launch(const Args* args, void* stream) {
  static int allowed[5] = {0, 0, 0, 0, 0};
  const Args a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(a.pos_tiles * a.head_tiles * a.n_splits, a.hkv, a.b);
  if (a.body != 0) {
#if DH % 16 == 0
    if (a.dtype != 1) return (int)cudaErrorInvalidValue;
    if (a.body == 1) {
      CUtensorMap tmk, tmv;
      int err = tensor_map(&tmk, a.k, a, a.ksl, a.ksh, a.ksb);
      if (!err) err = tensor_map(&tmv, a.v, a, a.vsl, a.vsh, a.vsb);
      if (err) return err;
      allow_smem(flash_tc, a.smem, &allowed[2]);
      flash_tc<<<grid, THREADS, a.smem, st>>>(a, tmk, tmv);
    } else {
      CUtensorMap tmk, tmv;
      int err = tensor_map(&tmk, a.k, a, a.ksl, a.ksh, a.ksb);
      if (!err) err = tensor_map(&tmv, a.v, a, a.vsl, a.vsh, a.vsb);
      if (err) return err;
      if (a.hc * a.tq <= 8) {
        allow_smem(flash_decode<1>, a.smem, &allowed[3]);
        flash_decode<1><<<grid, THREADS, a.smem, st>>>(a, tmk, tmv);
      } else {
        allow_smem(flash_decode<2>, a.smem, &allowed[4]);
        flash_decode<2><<<grid, THREADS, a.smem, st>>>(a, tmk, tmv);
      }
    }
#else
    return (int)cudaErrorInvalidValue;
#endif
  } else {
    if (a.dtype == 1) {
      allow_smem(flash_simt<__nv_bfloat16>, a.smem, &allowed[1]);
      flash_simt<__nv_bfloat16><<<grid, THREADS, a.smem, st>>>(a);
    } else {
      allow_smem(flash_simt<float>, a.smem, &allowed[0]);
      flash_simt<float><<<grid, THREADS, a.smem, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
}
