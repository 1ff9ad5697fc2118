// GQA flash attention backward for Hopper: dQ, dK and dV of
// csrc/flash_attention.cu's forward at a cotangent dO, bf16 inputs read
// through their (batch, head, position) strides, f32 sums, gradients in
// bf16.
//
// Replaces: no Pallas kernel.  The reference has no backward kernel: off
// the TPU it differentiates its plain attention (src/repro/kernels/ops.py
// _resolve, "ref" branch; src/repro/kernels/ref.py:181 flash_attention),
// and kernels/ref.py:flash_attention_backward is this port's plain
// version of that gradient.  It is added because training through
// attention blocks needs a gradient on the card, and the forward's kernel
// has none of its own.
//
// Semantics kept from the forward: masked logits are 0 probability,
// query position i sees keys <= i + kv_offset when causal, keys past Lk
// are masked, query head h reads KV head h / group, and a row whose keys
// are all masked (l = 0) gets zero gradient.  No float atomics: every sum
// runs in a fixed order inside one CTA, so the result does not depend on
// the order in which CTAs run.
//
// Two kernels, launched in this order on the caller's stream:
//
// flash_bwd_dq: a CTA owns (batch, query head, 64 query rows); warp w owns
//   rows 16w .. 16w + 15.  Q and dO stay in shared memory; D = rowsum(dO O)
//   per row (f32, O as the forward wrote it).  Pass 1 walks the visible
//   key tiles (32 keys, cp.async, 2 stages) for the row's log-sum-exp of
//   S * scale (in units of log2, so that P = exp2(s - lse) is one
//   MUFU.EX2; +inf for a dead row, whose P is then 0).  Pass 2 walks them
//   again for P, dP = dO V^T, dS = P (dP - D) and dQ += dS K, then writes
//   dQ * scale.  The row's lse and D go to a [B, Hq, Lq_pad] scratch for
//   the second kernel.
// flash_bwd_dkv: a CTA owns (batch, KV head, 64 keys, DC of the DH output
//   columns); warp w owns keys 16w .. 16w + 15.  K and V stay in shared
//   memory; the CTA walks the group's query heads in order 0..group-1
//   and, for each, the query tiles (32 rows, Q, dO, lse and D by cp.async,
//   2 stages) that can see its keys: S^T = K Q^T, P^T, dP^T = V dO^T,
//   dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q on its
//   columns; dK is scaled on write.  Above DH 128 the columns are cut in
//   two CTAs (DC = DH / 2): at DH 256, 128 f32 accumulators a thread for
//   dK and dV together, where 256 would spill; each of the two recomputes
//   S^T and dP^T.
//
// Tiles wholly above the shifted diagonal are never visited: a dQ CTA's
// keys end at its last row's causal end, a dK/dV CTA's queries start at
// the first row that sees its first key.
//
// Products: mma.sync m16n8k16, bf16 in, f32 sums; operands by ldmatrix
// from shared-memory rows of DH bf16 padded by 16 bytes (a row stride of
// 16 mod 128 bytes, so the eight rows of an 8x8 matrix fall in eight bank
// groups).  The product accumulators hand their f32 values to the next
// product as A fragments (S^T's layout is P^T's A operand), rounded once
// to bf16: P and dS enter the tensor cores as one bf16 term each (relative
// rounding 2^-9), where the forward's P V takes three; the gradients are
// held to the f32 plain backward by a relative-norm limit per input
// (chip_smoke.py:FLASH_GRAD_REL_LIMIT) for that reason.
//
// Bound: operations.  The gradient needs five products, 10 Dh flops per
// visible (query, key) pair and query head; this design does 16 Dh (S in
// both kernels and pass 1, dP in both), 20 Dh at DH 256 (the column cut
// recomputes S^T and dP^T).  The wgmma/TMA design is later work (PERF.md
// §7).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#ifndef DH
#error "DH (the head dimension) is defined by kernels/flash_attention.py"
#endif
#if DH % 16 != 0 || DH > 256 || (DH > 128 && DH % 32 != 0)
#error "DH must be a multiple of 16 to 128, of 32 to 256"
#endif

#define THREADS 128
#define STAGES 2     // cp.async ring stages of both kernels
#define DQ_ROWS 64   // query rows per dQ CTA (16 a warp)
#define DQ_BK 32     // keys per tile, dQ kernel
#define KV_KEYS 64   // keys per dK/dV CTA (16 a warp)
#define KV_BQ 32     // query rows per tile, dK/dV kernel

typedef __nv_bfloat16 bf16;

constexpr int NCOL = DH > 128 ? 2 : 1;   // CTAs over a key tile's columns
constexpr int DC = DH / NCOL;            // dK/dV output columns of a CTA
constexpr int RS = DH * 2 + 16;          // bytes per shared-memory row
constexpr int CH = DH / 8;               // 16-byte chunks per row
constexpr int SMEM_DQ = 2 * DQ_ROWS * RS + STAGES * 2 * DQ_BK * RS +
                        2 * DQ_ROWS * 4;
constexpr int SMEM_DKV = 2 * KV_KEYS * RS +
                         STAGES * (2 * KV_BQ * RS + 2 * KV_BQ * 4);

// One call's arguments, as kernels/flash_attention.py packs them.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;     // [B, Hq, Lq, DH]
  void* dk;     // [B, Hkv, Lk, DH]
  void* dv;
  float* lse;   // [B, Hq, Lq_pad] scratch: log2-sum-exp2 of s * scale
  float* dd;    // [B, Hq, Lq_pad] scratch: D = rowsum(dO O)
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl,
      dsb, dsh, dsl;   // element strides
  int b, hq, hkv, lq, lk, lq_pad, causal, kv_offset, ncol, smem_dq,
      smem_dkv;
  float scale;
};
static_assert(sizeof(Args) == 248, "Args must match the wrapper's packing");

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared without registers; valid false fills zeros
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
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offsets of this lane's ldmatrix row inside a tile of RS-byte rows.
// a_off: matrices rows 0-7 / 8-15 x columns 0-7 / 8-15 of a 16 x 16 block,
// both for an A operand (rows x k) and, transposed, for a B operand stored
// as rows k x columns n.  b_off: a B operand stored as rows n x columns k
// (16 n x 16 k), non-transposed: matrices n 0-7 k 0-7, n 0-7 k 8-15, n 8-15
// k 0-7, n 8-15 k 8-15.
__device__ __forceinline__ int a_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 16;
}
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 16;
}

// acc[NB][4] (16 rows x 8 NB columns) = A (16 rows of a, K = DH) times
// B^T (8 NB rows of b, K = DH), both from shared memory
template <int NB>
__device__ __forceinline__ void rows_times_rows(float (*acc)[4],
                                                const unsigned char* a,
                                                const unsigned char* b,
                                                int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const unsigned char* pa = a + a_off(lane);
  const unsigned char* pb = b + b_off(lane);
#pragma unroll 4
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, pa + kk * 32);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t bf[4];
      ldsm_x4(bf, pb + n2 * 16 * RS + kk * 32);
      mma16816(acc[2 * n2], af, bf[0], bf[1]);
      mma16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[NC / 8][4] (16 rows x NC columns from column c0) += A (fragments of
// 16 rows x 16 KS k, from registers) times B (16 KS rows of b, columns
// c0 .. c0 + NC - 1, from shared memory)
template <int KS, int NC>
__device__ __forceinline__ void frags_times_rows(float (*acc)[4],
                                                 const uint32_t (*af)[4],
                                                 const unsigned char* b,
                                                 int c0, int lane) {
  const unsigned char* pb = b + a_off(lane) + c0 * 2;
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int nd = 0; nd < NC / 16; ++nd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, pb + j * 16 * RS + nd * 32);
      mma16816(acc[2 * nd], af[j], bf[0], bf[1]);
      mma16816(acc[2 * nd + 1], af[j], bf[2], bf[3]);
    }
}

// the accumulators of NB n8 blocks (16 rows x 8 NB columns) as the A
// fragments of NB / 2 k16 steps, in bf16
template <int NB>
__device__ __forceinline__ void to_frags(const float (*x)[4],
                                         uint32_t (*af)[4]) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    af[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    af[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    af[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    af[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// rows of 64 * CH chunks of a [.., L, DH] tensor from position p0 into
// shared memory; positions at or past `end` arrive as zeros
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src,
                                          long long sl, int p0, int rows,
                                          int end, int tid) {
  for (int c = tid; c < rows * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = p0 + r < end;
    cp_async16(dst + r * RS + ch * 16,
               src + (long long)(ok ? p0 + r : 0) * sl + ch * 8, ok);
  }
}

__device__ __forceinline__ bool visible(const Args& a, int pos, int key) {
  return pos < a.lq && key < a.lk && (!a.causal || key <= pos + a.kv_offset);
}

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                         // [DQ_ROWS][RS]
  unsigned char* dos = qs + DQ_ROWS * RS;           // [DQ_ROWS][RS]
  unsigned char* ring = dos + DQ_ROWS * RS;         // [STAGES][K, V]
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * 2 * DQ_BK * RS);
  float* dd_s = lse_s + DQ_ROWS;
  constexpr int TILE = DQ_BK * RS;

  const int group = a.hq / a.hkv;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * DQ_ROWS;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* o = static_cast<const bf16*>(a.o) + b * a.osb + h * a.osh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.dsb + h * a.dsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;

  load_rows(qs, q, a.qsl, q0, DQ_ROWS, a.lq, tid);
  load_rows(dos, dout, a.dsl, q0, DQ_ROWS, a.lq, tid);
  cp_async_commit();

  // the keys any row of the tile sees
  const int last = min(a.lq, q0 + DQ_ROWS) - 1;
  int k_hi = a.lk;
  if (a.causal) k_hi = max(0, min(k_hi, last + a.kv_offset + 1));
  const int ntiles = (k_hi + DQ_BK - 1) / DQ_BK;
  auto load_kv = [&](int t, bool with_v) {
    if (t < ntiles) {
      unsigned char* st = ring + (t % STAGES) * 2 * TILE;
      load_rows(st, kb, a.ksl, t * DQ_BK, DQ_BK, a.lk, tid);
      if (with_v) load_rows(st + TILE, vb, a.vsl, t * DQ_BK, DQ_BK, a.lk, tid);
    }
    cp_async_commit();
  };

  // D = rowsum(dO O): thread pairs take a row's two halves, in column order
  cp_async_wait<0>();
  __syncthreads();
  {
    const int r = tid >> 1, c0 = (tid & 1) * (DH / 2);
    float acc = 0.0f;
    if (q0 + r < a.lq) {
      const bf16* orow = o + (long long)(q0 + r) * a.osl + c0;
      const bf16* drow = reinterpret_cast<const bf16*>(dos + r * RS) + c0;
#pragma unroll 4
      for (int c = 0; c < DH / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(oe[e]), __bfloat162float(de[e]), acc);
      }
    }
    const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) dd_s[r] = acc + other;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int pos0 = q0 + r0, pos1 = q0 + r1;
  const float scale2 = a.scale * 1.4426950408889634f;
  const unsigned char* qw = qs + warp * 16 * RS;
  const unsigned char* dow = dos + warp * 16 * RS;

  // pass 1: each thread's running (max, sum) over its columns, then the
  // four lanes of a row combine theirs
  float m0 = -FLT_MAX, m1 = -FLT_MAX, l0 = 0.0f, l1 = 0.0f;
  load_kv(0, false);
  for (int t = 0; t < ntiles; ++t) {
    load_kv(t + 1, false);
    cp_async_wait<1>();
    __syncthreads();
    float s[DQ_BK / 8][4];
    rows_times_rows<DQ_BK / 8>(s, qw, ring + (t % STAGES) * 2 * TILE, lane);
    uint32_t ok = 0;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * DQ_BK + 8 * n + 2 * t4 + (e & 1);
        const bool hi = e >= 2;
        s[n][e] *= scale2;
        if (visible(a, hi ? pos1 : pos0, key)) {
          ok |= 1u << (4 * n + e);
          if (hi) mx1 = fmaxf(mx1, s[n][e]);
          else mx0 = fmaxf(mx0, s[n][e]);
        }
      }
    l0 *= ex2(m0 - mx0);
    l1 *= ex2(m1 - mx1);
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((ok >> (4 * n + e)) & 1u) {
          if (e >= 2) l1 += ex2(s[n][e] - mx1);
          else l0 += ex2(s[n][e] - mx0);
        }
    m0 = mx0;
    m1 = mx1;
    __syncthreads();  // the stage is free for tile t + 2
  }
  // lanes t and t ^ o add the same two terms in either order: every lane
  // of the row ends with the same bits
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float mo0 = __shfl_xor_sync(0xffffffffu, m0, off);
    const float lo0 = __shfl_xor_sync(0xffffffffu, l0, off);
    const float mo1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const float lo1 = __shfl_xor_sync(0xffffffffu, l1, off);
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    l0 = l0 * ex2(m0 - mn0) + lo0 * ex2(mo0 - mn0);
    l1 = l1 * ex2(m1 - mn1) + lo1 * ex2(mo1 - mn1);
    m0 = mn0;
    m1 = mn1;
  }
  const float lse0 = l0 > 0.0f ? m0 + log2f(l0) : INFINITY;
  const float lse1 = l1 > 0.0f ? m1 + log2f(l1) : INFINITY;
  if (t4 == 0) {
    lse_s[r0] = lse0;
    lse_s[r1] = lse1;
  }
  __syncthreads();
  if (tid < DQ_ROWS) {
    const long long at = ((long long)b * a.hq + h) * a.lq_pad + q0 + tid;
    a.lse[at] = lse_s[tid];
    a.dd[at] = dd_s[tid];
  }
  const float d0 = dd_s[r0], d1 = dd_s[r1];

  // pass 2: dQ += dS K over the same key tiles
  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  load_kv(0, true);
  for (int t = 0; t < ntiles; ++t) {
    load_kv(t + 1, true);
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* kt = ring + (t % STAGES) * 2 * TILE;
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
    rows_times_rows<DQ_BK / 8>(s, qw, kt, lane);
    rows_times_rows<DQ_BK / 8>(dp, dow, kt + TILE, lane);
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * DQ_BK + 8 * n + 2 * t4 + (e & 1);
        const bool hi = e >= 2;
        const float p = visible(a, hi ? pos1 : pos0, key)
                            ? ex2(s[n][e] * scale2 - (hi ? lse1 : lse0))
                            : 0.0f;
        dp[n][e] = p * (dp[n][e] - (hi ? d1 : d0));
      }
    uint32_t ds[DQ_BK / 16][4];
    to_frags<DQ_BK / 8>(dp, ds);
    frags_times_rows<DQ_BK / 16, DH>(dq, ds, kt, 0, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.dq) + ((long long)b * a.hq + h) * a.lq * DH;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    if (pos0 < a.lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)pos0 * DH + col) =
          __floats2bfloat162_rn(dq[n][0] * a.scale, dq[n][1] * a.scale);
    if (pos1 < a.lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)pos1 * DH + col) =
          __floats2bfloat162_rn(dq[n][2] * a.scale, dq[n][3] * a.scale);
  }
}

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                         // [KV_KEYS][RS]
  unsigned char* vs = ks + KV_KEYS * RS;            // [KV_KEYS][RS]
  unsigned char* ring = vs + KV_KEYS * RS;          // [STAGES][Q, dO]
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * KV_BQ * RS);
  constexpr int TILE = KV_BQ * RS;                  // [STAGES][lse, D]

  const int group = a.hq / a.hkv;
  const int hk = blockIdx.y / a.ncol, c0 = (blockIdx.y % a.ncol) * DC;
  const int b = blockIdx.z, k0 = blockIdx.x * KV_KEYS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_rows(ks, static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh,
            a.ksl, k0, KV_KEYS, a.lk, tid);
  load_rows(vs, static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh,
            a.vsl, k0, KV_KEYS, a.lk, tid);
  cp_async_commit();

  // the query tiles that see a key of this tile: rows from the first that
  // sees key k0
  const int i_lo = a.causal ? max(0, k0 - a.kv_offset) : 0;
  const int qt_lo = i_lo / KV_BQ;
  const int nq = i_lo < a.lq ? (a.lq + KV_BQ - 1) / KV_BQ - qt_lo : 0;
  const int heads = group;  // the group's query heads, summed in order
  const int n_it = heads * nq;
  auto load_q = [&](int it) {
    if (it < n_it) {
      const int h = hk * group + it / nq, p0 = (qt_lo + it % nq) * KV_BQ;
      unsigned char* st = ring + (it % STAGES) * 2 * TILE;
      load_rows(st, static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh,
                a.qsl, p0, KV_BQ, a.lq, tid);
      load_rows(st + TILE,
                static_cast<const bf16*>(a.dout) + b * a.dsb + h * a.dsh,
                a.dsl, p0, KV_BQ, a.lq, tid);
      // lse and D of the tile's rows (the scratch is padded to Lq_pad)
      float* sst = stats + (it % STAGES) * 2 * KV_BQ;
      const long long at = ((long long)b * a.hq + h) * a.lq_pad + p0;
      if (tid < KV_BQ / 4)
        cp_async16(sst + 4 * tid, a.lse + at + 4 * tid, true);
      else if (tid < KV_BQ / 2)
        cp_async16(sst + KV_BQ + 4 * (tid - KV_BQ / 4),
                   a.dd + at + 4 * (tid - KV_BQ / 4), true);
    }
    cp_async_commit();
  };

  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const float scale2 = a.scale * 1.4426950408889634f;
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  load_q(0);
  for (int it = 0; it < n_it; ++it) {
    load_q(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* qt = ring + (it % STAGES) * 2 * TILE;
    const unsigned char* dot = qt + TILE;
    const float* lse_s = stats + (it % STAGES) * 2 * KV_BQ;
    const float* dd_s = lse_s + KV_BQ;
    const int p0 = (qt_lo + it % nq) * KV_BQ;
    float s[KV_BQ / 8][4], dp[KV_BQ / 8][4];
    rows_times_rows<KV_BQ / 8>(s, ks + warp * 16 * RS, qt, lane);
    rows_times_rows<KV_BQ / 8>(dp, vs + warp * 16 * RS, dot, lane);
#pragma unroll
    for (int n = 0; n < KV_BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        const float p = visible(a, p0 + j, e >= 2 ? key1 : key0)
                            ? ex2(s[n][e] * scale2 - lse_s[j])
                            : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dd_s[j]);
      }
    uint32_t pf[KV_BQ / 16][4], dsf[KV_BQ / 16][4];
    to_frags<KV_BQ / 8>(s, pf);
    to_frags<KV_BQ / 8>(dp, dsf);
    frags_times_rows<KV_BQ / 16, DC>(dv, pf, dot, c0, lane);
    frags_times_rows<KV_BQ / 16, DC>(dk, dsf, qt, c0, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long base = ((long long)b * a.hkv + hk) * a.lk;
  bf16* gk = static_cast<bf16*>(a.dk) + base * DH + c0;
  bf16* gv = static_cast<bf16*>(a.dv) + base * DH + c0;
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    if (key0 < a.lk) {
      *reinterpret_cast<__nv_bfloat162*>(gk + (long long)key0 * DH + col) =
          __floats2bfloat162_rn(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + (long long)key0 * DH + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (key1 < a.lk) {
      *reinterpret_cast<__nv_bfloat162*>(gk + (long long)key1 * DH + col) =
          __floats2bfloat162_rn(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + (long long)key1 * DH + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// The two launches of one call: dQ (and the lse/D scratch), then dK/dV.
// Refuses a call whose shared memory is not what this source lays out
// (the wrapper's plan must agree with it).
extern "C" int launch(const Args* a, void* stream) {
  if (a->smem_dq != SMEM_DQ || a->smem_dkv != SMEM_DKV || a->ncol != NCOL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DKV);
  if (err != cudaSuccess) return (int)err;
  const dim3 gq(a->lq_pad / DQ_ROWS, a->hq, a->b);
  flash_bwd_dq<<<gq, THREADS, SMEM_DQ, st>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gk((a->lk + KV_KEYS - 1) / KV_KEYS, a->hkv * NCOL, a->b);
  flash_bwd_dkv<<<gk, THREADS, SMEM_DKV, st>>>(*a);
  return (int)cudaGetLastError();
}

// What this build lays out: {SMEM_DQ, SMEM_DKV, NCOL, DQ_ROWS, DQ_BK,
// KV_KEYS, KV_BQ, STAGES}.
extern "C" int layout(int* out) {
  const int v[8] = {SMEM_DQ, SMEM_DKV, NCOL, DQ_ROWS, DQ_BK, KV_KEYS, KV_BQ,
                    STAGES};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
