// Chunkwise mLSTM (xLSTM matrix memory) for Hopper: a chunk-state scan and
// chunk-parallel tensor-core tiles, forward and backward.
//
// Replaces: src/repro/kernels/mlstm.py:mlstm_chunked (pallas_call at :102,
// body _kernel :34); its gradient, which the reference takes by autodiff
// of the plain scan, is the backward here.  csrc/mlstm.cu keeps the
// CUDA-core body for the shapes this one does not take
// (kernels/mlstm.py:plan picks by shape).
//
// Math (per (batch, head), chunk of W rows, f32, q pre-scaled), as in
// csrc/mlstm.cu: cum = cumsum(logf) in the chunk, total = cum[W-1],
// m_t = max(max_{s<=t} cum_t - cum_s + logi_s, cum_t), P[t,s] =
// exp(cum_t - cum_s + logi_s - m_t) (s <= t), att = (q k^T) * P, dec_t =
// exp(cum_t - m_t), wgt_s = exp(total - cum_s + logi_s), num = att v +
// (dec q) C, den = rowsum(att) + dec (q . n), out = num / max(|den|, e^-m),
// C' = e^total C + (k wgt)^T v, n' = e^total n + sum_s k_s wgt_s.
//
// Design: the sequential part and the chunk work are split (the
// "state-passing" and "chunk-parallel" pair of chunkwise linear
// attention).  Forward, three launches:
//   mlstm_gates   grid (NC, BH): cum and m per row, once for every kernel
//                 (so all of them see the same bits);
//   mlstm_scan    grid (D/TV, D/TK, BH), up to 8 warps: one [TK, TV] tile
//                 of C in registers walks the chunks, writes each chunk's
//                 entry state (staged in shared memory, stored as float4
//                 rows) and applies C <- e^total C + (k wgt)^T v; the
//                 tiles of v 0 carry n;
//   mlstm_out     grid (NC, BH), W/8 warps: one chunk, all Dh columns:
//                 S = q k^T once (causal tiles only), att, den, then
//                 num = att v + (dec q) C_prev in one accumulator.
// Backward, three launches: mlstm_dden (g and dden per row, from the
// saved out, den and m), mlstm_scan<bwd> (dC <- e^total dC + (dec q)^T
// dnum, the tiles of v 0 carry dn, and each tile's share of <dC', C> +
// <dn', n> for dlogf), and mlstm_bwd_chunk (grid (NC, BH)): S and
// dA = dnum v^T, then dq = dec dnum C^T + dS k, dk = wgt (v dC'^T + dn') +
// dS^T q, dv = wgt k dC' + att^T dnum and the gate gradients, one
// product phase after another through one accumulator (MR row tiles x
// Dh / CG columns a warp), two CTAs a SM.
// m_row is held constant (num, den and the clamp e^-m all carry e^-m, so
// out does not depend on it; the reference's gradient through the max
// cancels to rounding).  Every cross-thread and cross-CTA sum runs in a
// fixed order (shuffle butterflies, per-warp and per-tile partials summed
// in index order); no float atomics, two runs are bit-equal.
//
// Products: mma.sync m16n8k8 TF32 with fragments loaded by hand from
// shared memory (any operand layout; strides padded so a fragment load is
// free of bank conflicts: +4 floats where the k index is contiguous, +8
// where the m or n index is).  The reference is f32, so each operand is
// split a = hi + lo (`split`) and a product is hi*hi + hi*lo + lo*hi:
// about 2^-18 relative, where one TF32 term (2^-10) does not hold the
// f32 limit chip_smoke.py derives.  Three bf16 terms (six products) would
// hold it too, at twice the products.  Operand tiles stream through a ring
// of STAGES shared-memory stages filled by cp.async.  exp, divisions and
// the gate arithmetic stay f32 on the CUDA cores.
//
// Bound: at W 64, Dh 256 the forward moves ~270 MB (q, k, v, out and the
// states) and does ~9.7 GFLOP; at the three-term TF32 rate (495/3 TFLOP/s)
// the bytes bound it, the backward (~20 GFLOP) the operations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

//@GENERATED@

#ifndef STAGES
#error "W, D, TK, TV and STAGES are defined by kernels/mlstm.py"
#endif

#define PA(x) ((x) + 4)        // row stride of an operand whose k is contiguous
#define PB(x) ((x) + 8)        // row stride of an operand whose m or n is
#define CT (W * 4)             // threads of a chunk-parallel CTA (W/8 warps)
#define MINB (CT <= 256 ? 2 : 1)  // chunk CTAs an SM should hold (registers)
// a scan CTA: SW warps, each owning SMT m-tiles of 16 rows x SNT n-tiles of
// 8 columns of the [TK, TV] tile
#define SW_ ((TK / 16) * (TV >= 32 ? TV / 32 : 1))
#define SW (SW_ < 8 ? SW_ : 8)
#define ST (32 * SW)
// the chunk kernels' product phases: warp w owns MR row tiles of 16 rows
// (row group w / CG) times NTW n-tiles of 8 columns (column group w % CG)
#define MR ((W % 32 == 0 && D % 32 == 0) ? 2 : 1)
#define CG (2 * MR)
#define NTW (D / 8 / CG)
#define KS 16                  // depth of a streamed product slice
#define KQ ((D % 32) ? 16 : 32)   // q k^T slice depth, forward
#define K1 ((W > 64) ? 8 : 16)    // S and dA slice depth, backward
#define NC_ ((long long)nc)

static_assert(W % 16 == 0 && W >= 16 && W <= 128, "chunk");
static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dimension");
static_assert(D % TK == 0 && D % TV == 0 && TK % 16 == 0 && TV % 16 == 0,
              "scan tile");

// shared-memory plan, in floats (kernels/mlstm.py:tc_smem models it for
// `plan`; mlstm_tc_layout reports what the launchers take).  A scan stage
// holds the chunk's tiles and, once they are consumed, the [TK][TV + 4]
// state tile on its way out (STATE_F), so it is the larger of the two.
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int STATE_F = TK * (TV + 4);
constexpr int SCAN_SB_F = cmax(W * PB(TK) + W * PB(TV) + 2 * W, STATE_F);
constexpr int SCAN_SB_B = W * PB(TK) + W * PB(TV) + 4 * W + TK * PB(TV) + TK;
static_assert(STATE_F <= SCAN_SB_F && STATE_F <= SCAN_SB_B,
              "the state tile is staged in one scan stage");
static_assert(SCAN_SB_F % 4 == 0 && SCAN_SB_B % 4 == 0,
              "scan stages keep float4 alignment");
constexpr int SCAN_F = STAGES * SCAN_SB_F + 2 * W + 8;
constexpr int SCAN_B = STAGES * SCAN_SB_B + 2 * W + 8;
constexpr int MTL = TK / 16;
constexpr int SMT = MTL >= SW ? MTL / SW : 1;
constexpr int SNG = MTL >= SW ? 1 : SW / MTL;
constexpr int SNT = TV / 8 / SNG;
static_assert(SNT >= 1 && (TV / 8) % SNG == 0 && SMT * SW >= MTL,
              "scan warp tiling");
constexpr int OUT_SB = cmax(cmax(2 * W * PA(KQ), 16 * PB(D)),
                            W * PA(KS) + 16 * PB(D));
constexpr int OUT_F = STAGES * OUT_SB + W * PA(W) + 6 * W + D;
constexpr int BWD_SB = cmax(cmax(4 * W * PA(K1), W * PA(KS) + D * PA(KS)),
                            W * PA(KS) + 16 * PB(D));
constexpr int BWD_F = STAGES * BWD_SB + W * PB(W) + W * PA(W) + 12 * W +
                      2 * CG * W +
                      (W / 16) * W + 2 * D;

// ------------------------------------------------------------ helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols floats (cols % 4 == 0) from global (row stride gs) to shared
// memory (row stride ss), 16 bytes a copy
template <int NTH>
__device__ __forceinline__ void tile_copy(float* dst, int ss, const float* src,
                                          long long gs, int rows, int cols) {
  const int per = cols >> 2;
  for (int i = threadIdx.x; i < rows * per; i += NTH) {
    const int r = i / per, c = (i - r * per) << 2;
    cp16(dst + r * ss + c, src + r * gs + c);
  }
}

// A ring of STAGES stages of SB floats: issue(i, buf) starts the copies of
// step i, body(i, buf) consumes them.  Ends with the ring free.
template <int SB, class Issue, class Body>
__device__ __forceinline__ void pipeline(float* ring, int n, Issue issue,
                                         Body body) {
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s, ring + s * SB);
    cp_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < n) issue(nx, ring + (nx % STAGES) * SB);
    cp_commit();
    body(i, ring + (i % STAGES) * SB);
  }
  __syncthreads();
}

// TF32 fragments of mma.sync m16n8k8, each value split hi + lo
struct FA { uint32_t hi[4], lo[4]; };
struct FB { uint32_t hi[2], lo[2]; };

// hi = x with its low 13 bits cleared (a TF32 value), lo = x - hi (exact
// in f32); the tensor cores read lo's top 11 bits.  |x - hi - lo's TF32| <=
// 2^-20 |x|, and a product hi*hi + hi*lo + lo*hi is within ~3 2^-20 of
// x*y (cvt.rna on both parts would give ~2^-21 for three more
// conversions a value; the sweep's ablation times both)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// f(m, k) of the 16 x 8 A tile: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4), g = lane / 4, t = lane % 4
template <class F>
__device__ __forceinline__ void frag_a(FA& a, F f) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split(f(g, t), a.hi[0], a.lo[0]);
  split(f(g + 8, t), a.hi[1], a.lo[1]);
  split(f(g, t + 4), a.hi[2], a.lo[2]);
  split(f(g + 8, t + 4), a.hi[3], a.lo[3]);
}
// f(k, n) of the 8 x 8 B tile: b0 (t, g), b1 (t+4, g)
template <class F>
__device__ __forceinline__ void frag_b(FB& b, F f) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split(f(t, g), b.hi[0], b.lo[0]);
  split(f(t + 4, g), b.hi[1], b.lo[1]);
}
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in three TF32 terms, the small ones first; accumulator element
// e of d is (row g + 8 (e / 2), column 2 t + e % 2)
__device__ __forceinline__ void mma3(float* d, const FA& a, const FB& b) {
  mma(d, a.lo, b.hi);  // lo term
  mma(d, a.hi, b.lo);  // lo term
  mma(d, a.hi, b.hi);
}

// The chunk kernels' accumulator: acc[mi][nt] is the 16 x 8 tile of row
// tile rg MR + mi and columns c0 + 8 nt, c0 = cg NTW 8.
typedef float Acc[MR][NTW][4];

__device__ __forceinline__ void acc_zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
}

// f(x, t, col) for every element x of acc at chunk row t and column col
template <class F>
__device__ __forceinline__ void acc_each(Acc& acc, int rg, int cg, F f) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(acc[mi][nt][e], (rg * MR + mi) * 16 + gq + 8 * (e >> 1),
          cg * NTW * 8 + nt * 8 + 2 * tq + (e & 1));
}

// one k8 step of acc += A B over this warp's tiles: fa(t, k) the A element
// of chunk row t, fb(k, col) the B element of column col; row tile rt
// takes part where live(rt)
template <class FAf, class FBf, class Live>
__device__ __forceinline__ void acc_step(Acc& acc, int rg, int cg, FAf fa,
                                         FBf fb, Live live) {
  FA a[MR];
#pragma unroll
  for (int mi = 0; mi < MR; ++mi) {
    const int rt = rg * MR + mi;
    if (live(rt)) frag_a(a[mi], [&](int m, int k) { return fa(rt * 16 + m, k); });
  }
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    FB b;
    const int c0 = cg * NTW * 8 + nt * 8;
    frag_b(b, [&](int k, int n) { return fb(k, c0 + n); });
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
      if (live(rg * MR + mi)) mma3(acc[mi][nt], a[mi], b);
  }
}

// sum over the 4 lanes of a quad (the lanes that share g), the same bits
// in each
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ------------------------------------------------------------ gates
// cum_t = ((0 + logf_0) + logf_1) + ... + logf_t, m_t as above
extern "C" __global__ void __launch_bounds__(W) mlstm_gates(
    const float* __restrict__ logi, const float* __restrict__ logf,
    float* __restrict__ cum, float* __restrict__ mrow, int L) {
  __shared__ float lf[W], li[W], cs[W];
  const long long row0 = (long long)blockIdx.y * L + (long long)blockIdx.x * W;
  const int t = threadIdx.x;
  lf[t] = logf[row0 + t];
  li[t] = logi[row0 + t];
  __syncthreads();
  float a = 0.0f;
  for (int s = 0; s <= t; ++s) a = a + lf[s];
  cs[t] = a;
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s <= t; ++s) mx = fmaxf(mx, (a - cs[s]) + li[s]);
  cum[row0 + t] = a;
  mrow[row0 + t] = fmaxf(mx, a);
}

// ------------------------------------------------------------ scans
// Forward (BWD false), chunks in order: state out[c] = C entering chunk c,
// then C <- e^T C + (X r)^T Y with X = k, r = wgt, Y = v; vec n likewise.
// Backward, chunks in reverse: out[c] = dC leaving chunk c (entering
// c + 1), its share of <dC', C_c> + <dn', n_c> to part, then
// dC <- e^T dC + (X r)^T (Y / g) with X = q, r = dec, Y = dout; dn adds
// (q dec) dden.
template <bool BWD>
__device__ __forceinline__ void scan_body(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ cum, const float* __restrict__ aux,
    const float* __restrict__ g, const float* __restrict__ dden,
    const float* __restrict__ c_st, const float* __restrict__ n_st,
    float* __restrict__ st_out, float* __restrict__ vec_out,
    float* __restrict__ part, int L) {
  extern __shared__ __align__(16) float sm[];
  constexpr int SB = BWD ? SCAN_SB_B : SCAN_SB_F;
  float* ring = sm;
  float* rw = ring + STAGES * SB;  // [W] row weights
  float* rg = rw + W;              // [W] 1 / g (backward)
  float* red = rg + W;             // [SW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // this warp's m-tiles mt0 + SW mi and columns n0 + 8 nt
  const int mt0 = MTL >= SW ? warp : warp % MTL;
  const int n0 = (MTL >= SW ? 0 : warp / MTL) * SNT * 8;
  const int v0 = blockIdx.x * TV, k0 = blockIdx.y * TK;
  const long long bh = blockIdx.z;
  const int nc = L / W;
  const bool vec = blockIdx.x == 0;
  float acc[SMT][SNT][4];
#pragma unroll
  for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
  float nv = 0.0f;
  // stage layout: Xs [W][PB(TK)], Ys [W][PB(TV)], then [W] vectors: cum,
  // logi (forward) or cum, m, g, dden (backward), then (backward) Cs
  // [TK][PB(TV)] and ns [TK]
  auto issue = [&](int i, float* buf) {
    const int c = BWD ? nc - 1 - i : i;
    const long long row0 = bh * L + (long long)c * W;
    float* xs = buf;
    float* ys = xs + W * PB(TK);
    float* vv = ys + W * PB(TV);
    tile_copy<ST>(xs, PB(TK), X + row0 * D + k0, D, W, TK);
    tile_copy<ST>(ys, PB(TV), Y + row0 * D + v0, D, W, TV);
    tile_copy<ST>(vv, 0, cum + row0, 0, 1, W);
    tile_copy<ST>(vv + W, 0, aux + row0, 0, 1, W);
    if (BWD) {
      tile_copy<ST>(vv + 2 * W, 0, g + row0, 0, 1, W);
      tile_copy<ST>(vv + 3 * W, 0, dden + row0, 0, 1, W);
      float* cs = vv + 4 * W;
      const long long sc = (bh * NC_ + c) * D;
      tile_copy<ST>(cs, PB(TV), c_st + (sc + k0) * D + v0, D, TK, TV);
      tile_copy<ST>(cs + TK * PB(TV), 0, n_st + sc + k0, 0, 1, TK);
    }
  };
  // the state of chunk c from registers (acc, nv) to st_out / vec_out,
  // staged through `stage` ([TK][TV + 4], STATE_F floats of the stage just
  // consumed) so that rows leave as float4
  auto put_state = [&](int c, float* stage) {
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (mt0 + SW * mi) * 16 + gq + 8 * h;
          *(float2*)(stage + r * (TV + 4) + n0 + nt * 8 + 2 * tq) =
              make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        }
    __syncthreads();
    const long long sc = (bh * NC_ + c) * D;
    for (int x = tid; x < TK * TV / 4; x += ST) {
      const int r = x / (TV / 4), c4 = (x % (TV / 4)) * 4;
      *(float4*)(st_out + (sc + k0 + r) * D + v0 + c4) =
          *(const float4*)(stage + r * (TV + 4) + c4);
    }
    if (vec && tid < TK) vec_out[sc + k0 + tid] = nv;
  };
  auto body = [&](int i, float* buf) {
    const int c = BWD ? nc - 1 - i : i;
    const float* xs = buf;
    const float* ys = xs + W * PB(TK);
    const float* cumc = ys + W * PB(TV);
    const float* auxc = cumc + W;
    const float total = cumc[W - 1];
    for (int s = tid; s < W; s += ST) {
      if (BWD) {
        rw[s] = expf(cumc[s] - auxc[s]);
        rg[s] = 1.0f / cumc[2 * W + s];
      } else {
        rw[s] = expf((total - cumc[s]) + auxc[s]);
      }
    }
    if (i == 0) {  // the first state is 0: nothing has entered yet
      const long long sc = (bh * NC_ + c) * D;
      for (int x = tid; x < TK * TV / 4; x += ST)
        *(float4*)(st_out + (sc + k0 + x / (TV / 4)) * D + v0 +
                   (x % (TV / 4)) * 4) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec && tid < TK) vec_out[sc + k0 + tid] = 0.0f;
    }
    __syncthreads();
    const float e_total = expf(total);
    if (BWD) {  // this thread's share of <dC', C_c> + <dn', n_c>
      const float* cs = cumc + 4 * W;
      float p = 0.0f;
#pragma unroll
      for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (mt0 + SW * mi) * 16 + gq + 8 * (e >> 1);
            const int col = n0 + nt * 8 + 2 * tq + (e & 1);
            p = fmaf(acc[mi][nt][e], cs[r * PB(TV) + col], p);
          }
      if (vec && tid < TK) p = fmaf(nv, cs[TK * PB(TV) + tid], p);
#pragma unroll
      for (int o = 16; o; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) red[warp] = p;
      __syncthreads();
      if (tid == 0) {
        float a = red[0];
        for (int w = 1; w < SW; ++w) a = a + red[w];
        part[(bh * NC_ + c) * ((D / TK) * (D / TV)) + blockIdx.y * (D / TV) +
             blockIdx.x] = a;
      }
    }
    if (i == nc - 1) return;  // the state after the last chunk is not kept
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi) {
      const int mt = mt0 + SW * mi;
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] *= e_total;
#pragma unroll 2
      for (int ks = 0; ks < W / 8; ++ks) {
        FA a;
        frag_a(a, [&](int m, int k) {
          const int s = ks * 8 + k;
          return xs[s * PB(TK) + mt * 16 + m] * rw[s];
        });
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt) {
          FB b;
          frag_b(b, [&](int k, int n) {
            const int s = ks * 8 + k;
            const float y = ys[s * PB(TV) + n0 + nt * 8 + n];
            return BWD ? y * rg[s] : y;
          });
          mma3(acc[mi][nt], a, b);
        }
      }
    }
    if (vec && tid < TK) {
      float u = 0.0f;
      for (int s = 0; s < W; ++s) {
        float x = xs[s * PB(TK) + tid] * rw[s];
        if (BWD) x = x * cumc[3 * W + s];
        u = u + x;
      }
      nv = e_total * nv + u;
    }
    __syncthreads();  // every warp is done with this stage's tiles
    put_state(BWD ? c - 1 : c + 1, buf);
  };
  pipeline<SB>(ring, nc, issue, body);
}

extern "C" __global__ void __launch_bounds__(ST) mlstm_scan_fwd(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ cum, const float* __restrict__ logi,
    float* __restrict__ c_st, float* __restrict__ n_st, int L) {
  scan_body<false>(k, v, cum, logi, nullptr, nullptr, nullptr, nullptr, c_st,
                   n_st, nullptr, L);
}

extern "C" __global__ void __launch_bounds__(ST) mlstm_scan_bwd(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ cum, const float* __restrict__ mrow,
    const float* __restrict__ g, const float* __restrict__ dden,
    const float* __restrict__ c_st, const float* __restrict__ n_st,
    float* __restrict__ dc_st, float* __restrict__ dn_st,
    float* __restrict__ part, int L) {
  scan_body<true>(q, dout, cum, mrow, g, dden, c_st, n_st, dc_st, dn_st,
                  part, L);
}

// ------------------------------------------------------------ forward out
extern "C" __global__ void __launch_bounds__(CT, MINB) mlstm_out(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logi,
    const float* __restrict__ cum, const float* __restrict__ mrow,
    const float* __restrict__ c_st, const float* __restrict__ n_st,
    float* __restrict__ out, float* __restrict__ den_out, int L) {
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  float* att = ring + STAGES * OUT_SB;  // [W][PA(W)]
  float* cs = att + W * PA(W);          // [W] each
  float* ms = cs + W;
  float* li = ms + W;
  float* dec = li + W;
  float* gs = dec + W;
  float* qn = gs + W;
  float* ns = qn + W;                   // [D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rt = warp >> 1, ch = warp & 1;
  const int c = blockIdx.x;
  const long long bh = blockIdx.y;
  const int nc = L / W;
  const long long row0 = bh * L + (long long)c * W;
  const long long sc = (bh * NC_ + c) * D;
  if (tid < W) {
    cs[tid] = cum[row0 + tid];
    ms[tid] = mrow[row0 + tid];
    li[tid] = logi[row0 + tid];
    dec[tid] = expf(cs[tid] - ms[tid]);
  }
  for (int d = tid; d < D; d += CT) ns[d] = n_st[sc + d];
  __syncthreads();

  // S = q k^T over Dh slices of KQ; tiles (rt, j = ch + 2 ii), j <= 2 rt + 1
  float S[W / 16][4];
#pragma unroll
  for (int ii = 0; ii < W / 16; ++ii)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[ii][e] = 0.0f;
  float qn_acc = 0.0f;
  pipeline<OUT_SB>(
      ring, D / KQ,
      [&](int i, float* buf) {
        tile_copy<CT>(buf, PA(KQ), q + row0 * D + i * KQ, D, W, KQ);
        tile_copy<CT>(buf + W * PA(KQ), PA(KQ), k + row0 * D + i * KQ, D, W,
                      KQ);
      },
      [&](int i, float* buf) {
        const float* qs = buf;
        const float* ks = buf + W * PA(KQ);
#pragma unroll
        for (int kk = 0; kk < KQ / 8; ++kk) {
          FA a;
          frag_a(a, [&](int m, int x) {
            return qs[(rt * 16 + m) * PA(KQ) + kk * 8 + x];
          });
#pragma unroll
          for (int ii = 0; ii < W / 16; ++ii) {
            const int j = ch + 2 * ii;
            if (j <= 2 * rt + 1) {
              FB b;
              frag_b(b, [&](int x, int n) {
                return ks[(j * 8 + n) * PA(KQ) + kk * 8 + x];
              });
              mma3(S[ii], a, b);
            }
          }
        }
        if (tid < W)
          for (int dd = 0; dd < KQ; ++dd)
            qn_acc = fmaf(qs[tid * PA(KQ) + dd], ns[i * KQ + dd], qn_acc);
      });
  // att = S * P, masked entries 0
#pragma unroll
  for (int ii = 0; ii < W / 16; ++ii) {
    const int j = ch + 2 * ii;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = rt * 16 + gq + 8 * (e >> 1), s = j * 8 + 2 * tq + (e & 1);
      float a = 0.0f;
      if (s <= t) a = S[ii][e] * expf(((cs[t] - cs[s]) + li[s]) - ms[t]);
      att[t * PA(W) + s] = a;
    }
  }
  if (tid < W) qn[tid] = qn_acc;
  __syncthreads();
  if (tid < W) {
    float rs = 0.0f;
    for (int s = 0; s <= tid; ++s) rs = rs + att[tid * PA(W) + s];
    const float dn = rs + dec[tid] * qn[tid];
    den_out[row0 + tid] = dn;
    gs[tid] = fmaxf(fabsf(dn), expf(-ms[tid]));
  }
  // num = att v (chunk rows in slices of 16) + (dec q) C_prev
  const int rg = warp / CG, cg = warp % CG;
  Acc acc;
  acc_zero(acc);
  pipeline<OUT_SB>(
      ring, W / 16,
      [&](int i, float* buf) {
        tile_copy<CT>(buf, PB(D), v + (row0 + i * 16) * D, D, 16, D);
      },
      [&](int i, float* buf) {
        if (i > rg * MR + MR - 1) return;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          acc_step(
              acc, rg, cg,
              [&](int t, int x) {
                return att[t * PA(W) + i * 16 + kk * 8 + x];
              },
              [&](int x, int col) { return buf[(kk * 8 + x) * PB(D) + col]; },
              [&](int rt) { return i <= rt; });
      });
  pipeline<OUT_SB>(
      ring, D / KS,
      [&](int i, float* buf) {
        tile_copy<CT>(buf, PA(KS), q + row0 * D + i * KS, D, W, KS);
        tile_copy<CT>(buf + W * PA(KS), PB(D), c_st + (sc + i * KS) * D, D,
                      KS, D);
      },
      [&](int i, float* buf) {
        const float* qs = buf;
        const float* cb = buf + W * PA(KS);
#pragma unroll
        for (int kk = 0; kk < KS / 8; ++kk)
          acc_step(
              acc, rg, cg,
              [&](int t, int x) {
                return qs[t * PA(KS) + kk * 8 + x] * dec[t];
              },
              [&](int x, int col) { return cb[(kk * 8 + x) * PB(D) + col]; },
              [](int) { return true; });
      });
  acc_each(acc, rg, cg, [&](float& x, int t, int col) {
    out[(row0 + t) * D + col] = x / gs[t];
  });
}

// ------------------------------------------------------------ backward
// g = max(|den|, e^-m) and dden = -[|den| >= e^-m] sign(den) (dout . out)
// / g per row, one warp a row
extern "C" __global__ void __launch_bounds__(256) mlstm_dden(
    const float* __restrict__ out, const float* __restrict__ dout,
    const float* __restrict__ den, const float* __restrict__ mrow,
    float* __restrict__ g, float* __restrict__ dden, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(dout[row * D + d], out[row * D + d], acc);
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const float dn = den[row], em = expf(-mrow[row]);
    const float gg = fmaxf(fabsf(dn), em);
    const float sg = dn > 0.0f ? 1.0f : (dn < 0.0f ? -1.0f : 0.0f);
    g[row] = gg;
    dden[row] = fabsf(dn) >= em ? -sg * acc / gg : 0.0f;
  }
}

// One chunk's gradients from the chunk-entry state C, n (forward) and the
// cotangents dC', dn' of the state leaving it (mlstm_scan_bwd).
extern "C" __global__ void __launch_bounds__(CT, MINB) mlstm_bwd_chunk(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ logi, const float* __restrict__ cum,
    const float* __restrict__ mrow, const float* __restrict__ g,
    const float* __restrict__ dden, const float* __restrict__ c_st,
    const float* __restrict__ n_st, const float* __restrict__ dc_st,
    const float* __restrict__ dn_st, const float* __restrict__ part,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dlogi, float* __restrict__ dlogf, int L) {
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  float* att = ring + STAGES * BWD_SB;  // [W][PB(W)]
  float* dS = att + W * PB(W);          // [W][PA(W)]
  float* cs = dS + W * PA(W);           // [W] each, 16 of them
  float* ms = cs + W;
  float* li = ms + W;
  float* dec = li + W;
  float* wgt = dec + W;
  float* rg_s = wgt + W;
  float* dd = rg_s + W;
  float* qn = dd + W;
  float* dw = qn + W;
  float* dc = dw + W;
  float* rowp = dc + W;                 // [2][W]
  float* ddecp = rowp + 2 * W;          // [CG][W]
  float* dwgtp = ddecp + CG * W;        // [CG][W]
  float* colp = dwgtp + CG * W;         // [W/16][W]
  float* ns = colp + (W / 16) * W;      // [D]
  float* dns = ns + D;                  // [D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rt = warp >> 1, ch = warp & 1;
  const int c = blockIdx.x;
  const long long bh = blockIdx.y;
  const int nc = L / W;
  const long long row0 = bh * L + (long long)c * W;
  const long long sc = (bh * NC_ + c) * D;
  const float total = cum[row0 + W - 1];
  if (tid < W) {
    cs[tid] = cum[row0 + tid];
    ms[tid] = mrow[row0 + tid];
    li[tid] = logi[row0 + tid];
    dec[tid] = expf(cs[tid] - ms[tid]);
    wgt[tid] = expf((total - cs[tid]) + li[tid]);
    rg_s[tid] = 1.0f / g[row0 + tid];
    dd[tid] = dden[row0 + tid];
  }
  for (int d = tid; d < D; d += CT) {
    ns[d] = n_st[sc + d];
    dns[d] = dn_st[sc + d];
  }
  __syncthreads();

  // phase 1: S = q k^T and dA = dnum v^T over Dh slices of K1
  float S[W / 16][4], dA[W / 16][4];
#pragma unroll
  for (int ii = 0; ii < W / 16; ++ii)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[ii][e] = dA[ii][e] = 0.0f;
  float qn_acc = 0.0f;
  pipeline<BWD_SB>(
      ring, D / K1,
      [&](int i, float* buf) {
        const long long o = row0 * D + i * K1;
        tile_copy<CT>(buf, PA(K1), q + o, D, W, K1);
        tile_copy<CT>(buf + W * PA(K1), PA(K1), k + o, D, W, K1);
        tile_copy<CT>(buf + 2 * W * PA(K1), PA(K1), v + o, D, W, K1);
        tile_copy<CT>(buf + 3 * W * PA(K1), PA(K1), dout + o, D, W, K1);
      },
      [&](int i, float* buf) {
        const float* qs = buf;
        const float* ks = qs + W * PA(K1);
        const float* vs = ks + W * PA(K1);
        const float* ds = vs + W * PA(K1);
#pragma unroll
        for (int kk = 0; kk < K1 / 8; ++kk) {
          FA aq, ad;
          frag_a(aq, [&](int m, int x) {
            return qs[(rt * 16 + m) * PA(K1) + kk * 8 + x];
          });
          frag_a(ad, [&](int m, int x) {
            const int t = rt * 16 + m;
            return ds[t * PA(K1) + kk * 8 + x] * rg_s[t];
          });
#pragma unroll
          for (int ii = 0; ii < W / 16; ++ii) {
            const int j = ch + 2 * ii;
            if (j <= 2 * rt + 1) {
              FB b;
              frag_b(b, [&](int x, int n) {
                return ks[(j * 8 + n) * PA(K1) + kk * 8 + x];
              });
              mma3(S[ii], aq, b);
              frag_b(b, [&](int x, int n) {
                return vs[(j * 8 + n) * PA(K1) + kk * 8 + x];
              });
              mma3(dA[ii], ad, b);
            }
          }
        }
        if (tid < W)
          for (int x = 0; x < K1; ++x)
            qn_acc = fmaf(qs[tid * PA(K1) + x], ns[i * K1 + x], qn_acc);
      });
  // att, dS = (dA + dden) * P, and the row and column sums of
  // ddmat = (dA + dden) * att
  {
    float rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ii = 0; ii < W / 16; ++ii) {
      const int j = ch + 2 * ii;
      float csum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rt * 16 + gq + 8 * (e >> 1), s = j * 8 + 2 * tq + (e & 1);
        float a = 0.0f, ds = 0.0f, dm = 0.0f;
        if (s <= t) {
          const float p = expf(((cs[t] - cs[s]) + li[s]) - ms[t]);
          a = S[ii][e] * p;
          const float da = dA[ii][e] + dd[t];
          ds = da * p;
          dm = da * a;
        }
        att[t * PB(W) + s] = a;
        dS[t * PA(W) + s] = ds;
        rsum[e >> 1] += dm;
        csum[e & 1] += dm;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        csum[0] += __shfl_xor_sync(0xffffffffu, csum[0], o);
        csum[1] += __shfl_xor_sync(0xffffffffu, csum[1], o);
      }
      if (gq == 0) {
        colp[rt * W + j * 8 + 2 * tq] = csum[0];
        colp[rt * W + j * 8 + 2 * tq + 1] = csum[1];
      }
    }
    rsum[0] = quad_sum(rsum[0]);
    rsum[1] = quad_sum(rsum[1]);
    if (tq == 0) {
      rowp[ch * W + rt * 16 + gq] = rsum[0];
      rowp[ch * W + rt * 16 + gq + 8] = rsum[1];
    }
    if (tid < W) qn[tid] = qn_acc;
  }

  const int rg = warp / CG, cg = warp % CG;
  Acc acc;
  // acc += A B^T over Dh in slices of KS: A [W, Dh] (rows scaled by rg if
  // `scale`), B [Dh, Dh] (the state at sc), B's rows = output columns
  auto prod_nt = [&](const float* A, const float* B, bool scale) {
    pipeline<BWD_SB>(
        ring, D / KS,
        [&](int i, float* buf) {
          tile_copy<CT>(buf, PA(KS), A + row0 * D + i * KS, D, W, KS);
          tile_copy<CT>(buf + W * PA(KS), PA(KS), B + sc * D + i * KS, D, D,
                        KS);
        },
        [&](int i, float* buf) {
          const float* as = buf;
          const float* bs = buf + W * PA(KS);
#pragma unroll
          for (int kk = 0; kk < KS / 8; ++kk)
            acc_step(
                acc, rg, cg,
                [&](int t, int x) {
                  const float y = as[t * PA(KS) + kk * 8 + x];
                  return scale ? y * rg_s[t] : y;
                },
                [&](int x, int col) {
                  return bs[col * PA(KS) + kk * 8 + x];
                },
                [](int) { return true; });
        });
  };
  // acc += T X over the chunk rows in slices of 16: T(r, s) = Tm[r ts + s]
  // (trans false, nonzero for s <= r) or Tm[s ts + r] (trans, nonzero for
  // s >= r); X [W, Dh] rows scaled by rg if `scale`
  auto prod_chunk = [&](const float* Tm, int ts, bool trans,
                        const float* Xg, bool scale) {
    pipeline<BWD_SB>(
        ring, W / 16,
        [&](int i, float* buf) {
          tile_copy<CT>(buf, PB(D), Xg + (row0 + i * 16) * D, D, 16, D);
        },
        [&](int i, float* buf) {
          if (trans ? i < rg * MR : i > rg * MR + MR - 1) return;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            acc_step(
                acc, rg, cg,
                [&](int r, int x) {
                  const int s = i * 16 + kk * 8 + x;
                  return trans ? Tm[s * ts + r] : Tm[r * ts + s];
                },
                [&](int x, int col) {
                  const float y = buf[(kk * 8 + x) * PB(D) + col];
                  return scale ? y * rg_s[i * 16 + kk * 8 + x] : y;
                },
                [&](int rt) { return trans ? i >= rt : i <= rt; });
        });
  };
  auto store = [&](float* dst) {
    acc_each(acc, rg, cg, [&](float& x, int t, int col) {
      dst[(row0 + t) * D + col] = x;
    });
  };
  // per row t, sum over this warp's columns of Y[t, col] (acc + add[col]),
  // quad-reduced into outp[cg][t]
  auto row_dot = [&](const float* Y, const float* add, float* outp) {
    float p[MR][2];
#pragma unroll
    for (int mi = 0; mi < MR; ++mi) p[mi][0] = p[mi][1] = 0.0f;
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = (rg * MR + mi) * 16 + gq + 8 * h;
          const int col = cg * NTW * 8 + nt * 8 + 2 * tq;
          const float2 y = *(const float2*)(Y + (row0 + t) * D + col);
          float a0 = acc[mi][nt][2 * h], a1 = acc[mi][nt][2 * h + 1];
          if (add) { a0 = a0 + add[col]; a1 = a1 + add[col + 1]; }
          p[mi][h] = fmaf(y.x, a0, p[mi][h]);
          p[mi][h] = fmaf(y.y, a1, p[mi][h]);
        }
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = quad_sum(p[mi][h]);
        if (tq == 0) outp[cg * W + (rg * MR + mi) * 16 + gq + 8 * h] = x;
      }
  };

  // phase 2: E = dnum C^T; ddec = q . E; dq = dec E + dec dden n + dS k
  acc_zero(acc);
  prod_nt(dout, c_st, true);
  row_dot(q, nullptr, ddecp);
  acc_each(acc, rg, cg, [&](float& x, int t, int col) {
    x = dec[t] * x + (dec[t] * dd[t]) * ns[col];
  });
  prod_chunk(dS, PA(W), false, k, false);
  store(dq);
  // phase 3: F = v dC'^T; dwgt = k . (F + dn'); dk = wgt (F + dn') + dS^T q
  acc_zero(acc);
  prod_nt(v, dc_st, false);
  row_dot(k, dns, dwgtp);
  acc_each(acc, rg, cg, [&](float& x, int t, int col) {
    x = wgt[t] * (x + dns[col]);
  });
  prod_chunk(dS, PA(W), true, q, false);
  store(dk);
  // phase 4: dv = wgt (k dC') + att^T dnum
  acc_zero(acc);
  pipeline<BWD_SB>(
      ring, D / KS,
      [&](int i, float* buf) {
        tile_copy<CT>(buf, PA(KS), k + row0 * D + i * KS, D, W, KS);
        tile_copy<CT>(buf + W * PA(KS), PB(D), dc_st + (sc + i * KS) * D, D,
                      KS, D);
      },
      [&](int i, float* buf) {
        const float* ks = buf;
        const float* cb = buf + W * PA(KS);
#pragma unroll
        for (int kk = 0; kk < KS / 8; ++kk)
          acc_step(
              acc, rg, cg,
              [&](int t, int x) { return ks[t * PA(KS) + kk * 8 + x]; },
              [&](int x, int col) { return cb[(kk * 8 + x) * PB(D) + col]; },
              [](int) { return true; });
      });
  acc_each(acc, rg, cg, [&](float& x, int t, int) { x *= wgt[t]; });
  prod_chunk(att, PB(W), true, dout, true);
  store(dv);
  // phase 5: the gate gradients
  if (tid < W) {
    float dwg = dwgtp[tid], ddec = ddecp[tid];
    for (int c2 = 1; c2 < CG; ++c2) {
      dwg = dwg + dwgtp[c2 * W + tid];
      ddec = ddec + ddecp[c2 * W + tid];
    }
    const float dwt = dwg * wgt[tid];
    ddec = ddec + dd[tid] * qn[tid];
    float coldd = 0.0f;
    for (int r = 0; r < W / 16; ++r) coldd = coldd + colp[r * W + tid];
    const float rowdd = rowp[tid] + rowp[W + tid];
    dw[tid] = dwt;
    dlogi[row0 + tid] = coldd + dwt;
    dc[tid] = ((rowdd - coldd) + ddec * dec[tid]) - dwt;
  }
  __syncthreads();
  if (tid == 0) {
    const int nt = (D / TK) * (D / TV);
    float de = 0.0f;
    for (int i = 0; i < nt; ++i) de = de + part[(bh * NC_ + c) * nt + i];
    float dt = 0.0f;
    for (int s = 0; s < W; ++s) dt = dt + dw[s];
    dc[W - 1] = dc[W - 1] + (dt + de * expf(total));
    float a = 0.0f;  // through cumsum: a reverse cumsum in the chunk
    for (int t = W - 1; t >= 0; --t) {
      a = a + dc[t];
      dlogf[row0 + t] = a;
    }
  }
}

// ------------------------------------------------------------ launchers
static int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
static dim3 scan_grid(int BH) { return dim3(D / TV, D / TK, BH); }
static dim3 chunk_grid(int BH, int L) { return dim3(L / W, BH); }

// What the launchers run for B*H = BH and length L: out[0..3] the dynamic
// shared memory in bytes of mlstm_scan_fwd, mlstm_out, mlstm_scan_bwd and
// mlstm_bwd_chunk; out[4..6] the scans' grid, out[7..8] the chunk
// kernels'; out[9], out[10] the threads of a scan CTA and a chunk CTA.
extern "C" int mlstm_tc_layout(int BH, int L, int* out) {
  const dim3 sg = scan_grid(BH), cg = chunk_grid(BH, L);
  const int v[11] = {4 * SCAN_F, 4 * OUT_F, 4 * SCAN_B, 4 * BWD_F,
                     (int)sg.x, (int)sg.y, (int)sg.z, (int)cg.x, (int)cg.y,
                     ST, CT};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

extern "C" int launch_tc_fwd(const void* q, const void* k, const void* v,
                             const void* logi, const void* logf, void* out,
                             void* c_st, void* n_st, void* cum, void* mrow,
                             void* den, int BH, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  mlstm_gates<<<chunk_grid(BH, L), W, 0, st>>>(
      (const float*)logi, (const float*)logf, (float*)cum, (float*)mrow, L);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem((const void*)mlstm_scan_fwd, 4 * SCAN_F))) return err;
  mlstm_scan_fwd<<<scan_grid(BH), ST, 4 * SCAN_F, st>>>(
      (const float*)k, (const float*)v, (const float*)cum,
      (const float*)logi, (float*)c_st, (float*)n_st, L);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem((const void*)mlstm_out, 4 * OUT_F))) return err;
  mlstm_out<<<chunk_grid(BH, L), CT, 4 * OUT_F, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)logi,
      (const float*)cum, (const float*)mrow, (const float*)c_st,
      (const float*)n_st, (float*)out, (float*)den, L);
  return (int)cudaGetLastError();
}

extern "C" int launch_tc_bwd(const void* q, const void* k, const void* v,
                             const void* logi, const void* out,
                             const void* dout, const void* c_st,
                             const void* n_st, const void* cum,
                             const void* mrow, const void* den, void* g,
                             void* dden, void* dc_st, void* dn_st, void* part,
                             void* dq, void* dk, void* dv, void* dlogi,
                             void* dlogf, int BH, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)BH * L;
  int err;
  mlstm_dden<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const float*)out, (const float*)dout, (const float*)den,
      (const float*)mrow, (float*)g, (float*)dden, rows);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem((const void*)mlstm_scan_bwd, 4 * SCAN_B))) return err;
  mlstm_scan_bwd<<<scan_grid(BH), ST, 4 * SCAN_B, st>>>(
      (const float*)q, (const float*)dout, (const float*)cum,
      (const float*)mrow, (const float*)g, (const float*)dden,
      (const float*)c_st, (const float*)n_st, (float*)dc_st, (float*)dn_st,
      (float*)part, L);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem((const void*)mlstm_bwd_chunk, 4 * BWD_F))) return err;
  mlstm_bwd_chunk<<<chunk_grid(BH, L), CT, 4 * BWD_F, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)logi, (const float*)cum, (const float*)mrow,
      (const float*)g, (const float*)dden, (const float*)c_st,
      (const float*)n_st, (const float*)dc_st, (const float*)dn_st,
      (const float*)part, (float*)dq, (float*)dk, (float*)dv, (float*)dlogi,
      (float*)dlogf, L);
  return (int)cudaGetLastError();
}
