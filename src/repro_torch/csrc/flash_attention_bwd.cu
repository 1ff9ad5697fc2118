// GQA flash attention backward for Hopper: dQ, dK and dV of
// csrc/flash_attention.cu's forward at a cotangent dO, bf16 inputs read
// through their (batch, head, position) strides by the TMA unit, f32 sums,
// gradients in bf16.
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
// are all masked (the forward's log-sum-exp +inf) gets zero gradient.  No
// float atomics: every sum runs in a fixed order inside one CTA, so two
// runs give the same bits whatever order the CTAs run in.
//
// The forward writes each row's log-sum-exp (in units of log2 of S *
// scale, kernels/flash_attention.py:_Flash), so P = exp2(s - lse) needs no
// pass of its own.  Two kernels, launched in this order on the caller's
// stream, each of two warpgroups (256 threads) over 64-row wgmma tiles
// that one thread asks the TMA unit for (hopper.cuh: the 128-byte swizzle,
// mbarriers counting the bytes, a 2-stage ring):
//
// flash_bwd_dq: a CTA owns CTA_ROWS query rows of one head.  It first
//   takes D = rowsum(dO O) of its rows in a fixed order (THREADS /
//   CTA_ROWS threads a row on consecutive columns, added in column order)
//   and copies D and the forward's log-sum-exp to a [B, Hq, Lq_pad]
//   scratch for the second kernel (lse +inf past Lq).  Then it walks the
//   64-key K/V tiles its rows see: S = Q K^T, dP = dO V^T, dS = P (dP - D)
//   with P = exp2(S scale log2(e) - lse), dQ += dS K; dQ * scale on write.
// flash_bwd_dkv: a CTA owns CTA_ROWS keys of one KV head, K and V resident.
//   It walks the group's query heads in order 0..group-1 and, for each, the
//   64-row query tiles (Q, dO and the tile's lse and D by the TMA unit)
//   that see its first key: S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, then
//   dV += P^T dO and dK += dS^T Q; dK * scale on write.
//
// The CTA shape depends on the head dimension, padded to DHP (a multiple
// of 64: the TMA unit fills the padding with zeros):
//   DHP <= 128 (SPLIT false): each warpgroup owns its own 64 rows (query
//     rows, or keys) and every column; the two share the ring's tiles, so
//     a CTA of 128 rows reads each K/V (or Q/dO) tile once for both.
//     dK + dV at DH 128 are 64 + 64 f32 a thread.
//   DHP > 128 (SPLIT true): dK and dV of 64 keys x 256 columns are 256 f32
//     a thread for one warpgroup, over the 255-register limit, so both
//     warpgroups own the same 64 rows and each holds half of the output
//     columns (DHP / 2).  Warpgroup 0 computes S (S^T), warpgroup 1 dP
//     (dP^T), each over the whole DH reduction, and they swap them through
//     a 32 KB exchange in shared memory (warpgroup 0 hands P over), so each
//     product is computed once; both then form the same dS in the same
//     order and add their column halves.  At DH 256 the dK/dV CTA takes
//     K, V 64 KB + a 2 x 64 KB ring + the exchange 32 KB + lse/D = 225 KB.
//
// Tiles wholly above the shifted diagonal are never loaded: a dQ CTA's
// keys end at its last row's causal end, a dK/dV CTA's queries start at
// the first row that sees its first key.
//
// Products: wgmma m64n64k16 with both operands in shared memory for S,
// dP (S^T, dP^T); then P, dS from the accumulators' registers as the A
// operand (rounded once to bf16: P and dS enter the tensor cores as one
// bf16 term each, relative rounding 2^-9, where the forward's P V takes
// three; the gradients are held to the f32 plain backward by a relative-
// norm limit per input, chip_smoke.py:FLASH_GRAD_REL_LIMIT), with the
// other operand read MN-major from its tile (hopper.cuh:pv_cols).
//
// Bound: operations.  The gradient needs five products, 10 Dh flops per
// visible (query, key) pair and query head; this design does 14 Dh (S and
// dP in both kernels, plus dQ, dK, dV), the least without float atomics
// (dQ is summed over keys, dK and dV over queries: two kernels).
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#ifndef DH
#error "DH (the head dimension) is defined by kernels/flash_attention.py"
#endif
#if DH % 16 != 0 || DH > 256
#error "DH must be a multiple of 16 to 256"
#endif

#define THREADS 256  // two warpgroups
#define STAGES 2     // TMA ring stages of both kernels
#define BLK 64       // rows of a wgmma tile: query rows, keys
#define LOG2E 1.4426950408889634f

typedef __nv_bfloat16 bf16;

constexpr int DHP = (DH + 63) / 64 * 64;  // columns, padded to 64
constexpr int TILE = BLK * DHP * 2;       // bytes of a 64-row tile
constexpr bool SPLIT = DHP > 128;         // warpgroups on column halves
constexpr int NBLK = SPLIT ? 1 : 2;       // 64-row blocks of a CTA
constexpr int CTA_ROWS = NBLK * BLK;      // dQ CTA's rows, dK/dV CTA's keys
constexpr int ACC = SPLIT ? DHP / 2 : DH;  // output columns of a warpgroup
constexpr int END0 = SPLIT ? (DH < ACC ? DH : ACC) : DH;
constexpr int XCHG = SPLIT ? 2 * 32 * 128 * 4 : 0;  // exchange bytes
constexpr int SMEM_DQ = 2 * NBLK * TILE + STAGES * 2 * TILE + XCHG +
                        2 * CTA_ROWS * 4 + (STAGES + 1) * 8;
constexpr int SMEM_DKV = 2 * NBLK * TILE + STAGES * 2 * TILE + XCHG +
                         STAGES * 2 * BLK * 4 + (STAGES + 1) * 8;

// One call's arguments, as kernels/flash_attention.py packs them.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse_in;  // [B, Hq, Lq] the forward's log-sum-exp
  void* dq;     // [B, Hq, Lq, DH]
  void* dk;     // [B, Hkv, Lk, DH]
  void* dv;
  float* lse;   // [B, Hq, Lq_pad] scratch: lse_in, +inf past Lq
  float* dd;    // [B, Hq, Lq_pad] scratch: D = rowsum(dO O)
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl,
      dsb, dsh, dsl;   // element strides
  int b, hq, hkv, lq, lk, lq_pad, causal, kv_offset, smem_dq, smem_dkv;
  float scale;
};
static_assert(sizeof(Args) == 256, "Args must match the wrapper's packing");

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// acc (m64n64 accumulator) = A B^T over DH, both 64-row tiles K-major in
// shared memory; issued, not committed
__device__ __forceinline__ void ss_product(float* acc, const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(acc, desc_kmajor(a, kk), desc_kmajor(b, kk), 1);
}

// An m64n64 accumulator as the A fragments of four k16 steps, in bf16
// (the forward's P term 0)
__device__ __forceinline__ void to_frags(const float* x, uint32_t (*af)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      af[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc += A (four k16 steps of fragments) x the tile bt (64 rows, MN-major)
// on warpgroup wg's output columns; issued, not committed
__device__ __forceinline__ void cols_product(float* acc, const uint32_t (*af)[4],
                                             const unsigned char* bt, int wg) {
  if (!SPLIT || wg == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv_cols<0, 0, END0>(acc, af[kk], bt, kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv_cols<ACC, ACC, DH>(acc, af[kk], bt, kk);
  }
}

// SPLIT: warpgroup wg holds x (warpgroup 0 P, 1 dP) and writes it to the
// exchange; after the barrier both hold x = P and y = dP
__device__ __forceinline__ void swap_halves(float* x, float* y, float* xchg,
                                            int wg, int wt) {
  float* mine = xchg + wg * 32 * 128 + wt;
  const float* theirs = xchg + (1 - wg) * 32 * 128 + wt;
#pragma unroll
  for (int i = 0; i < 32; ++i) mine[i * 128] = x[i];
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = theirs[i * 128];
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      y[i] = x[i];
      x[i] = theirs[i * 128];
    }
  }
}

__device__ __forceinline__ void fence_acc(float* x) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(x[i]);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq(const Args a, const __grid_constant__ CUtensorMap tmq,
             const __grid_constant__ CUtensorMap tmk,
             const __grid_constant__ CUtensorMap tmv,
             const __grid_constant__ CUtensorMap tmdo) {
  extern __shared__ __align__(128) unsigned char smem[];
  // tiles start on 1024 bytes, the swizzle's period (no static shared
  // memory: the dynamic window starts so aligned)
  if (smem_u32(smem) & 1023) __trap();
  unsigned char* qs = smem;                         // [NBLK] Q tiles
  unsigned char* dos = qs + NBLK * TILE;            // [NBLK] dO tiles
  unsigned char* ring = dos + NBLK * TILE;          // [STAGES][K, V]
  float* xchg = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * 2 * TILE + XCHG);
  float* dd_s = lse_s + CTA_ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(dd_s + CTA_ROWS);
  uint64_t* qbar = full + STAGES;                   // Q and dO

  const int group = a.hq / a.hkv;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = wt >> 5;
  const int q0 = qt * CTA_ROWS;
  // the keys any row of the CTA sees
  const int last = min(a.lq, q0 + CTA_ROWS) - 1;
  int k_hi = a.lk;
  if (a.causal) k_hi = max(0, min(k_hi, last + a.kv_offset + 1));
  const int ntiles = (k_hi + BLK - 1) / BLK;

  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, 2 * NBLK * TILE);
    for (int blk = 0; blk < NBLK; ++blk)
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(qs + blk * TILE + cb * 64 * 128, &tmq, 64 * cb,
                 q0 + blk * BLK, h, b, qbar);
        tma_load(dos + blk * TILE + cb * 64 * 128, &tmdo, 64 * cb,
                 q0 + blk * BLK, h, b, qbar);
      }
  }
  auto load_kv = [&](int t) {
    if (tid == 0 && t < ntiles) {
      unsigned char* st = ring + (t % STAGES) * 2 * TILE;
      mbar_expect_tx(&full[t % STAGES], 2 * TILE);
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(st + cb * 64 * 128, &tmk, 64 * cb, t * BLK, hk, b,
                 &full[t % STAGES]);
        tma_load(st + TILE + cb * 64 * 128, &tmv, 64 * cb, t * BLK, hk, b,
                 &full[t % STAGES]);
      }
    }
  };
  for (int t = 0; t < STAGES; ++t) load_kv(t);

  // D = rowsum(dO O), TPR threads a row on consecutive CPT columns, added
  // in column order; the row's lse; both to shared memory and the scratch
  {
    constexpr int TPR = THREADS / CTA_ROWS, CPT = DH / TPR;
    const int r = tid / TPR, part = tid % TPR, pos = q0 + r;
    float acc = 0.0f;
    if (pos < a.lq) {
      const bf16* orow = static_cast<const bf16*>(a.o) + b * a.osb +
                         h * a.osh + (long long)pos * a.osl + part * CPT;
      const bf16* drow = static_cast<const bf16*>(a.dout) + b * a.dsb +
                         h * a.dsh + (long long)pos * a.dsl + part * CPT;
#pragma unroll 4
      for (int c = 0; c < CPT; c += 4) {
        const uint2 ov = *reinterpret_cast<const uint2*>(orow + c);
        const uint2 dv = *reinterpret_cast<const uint2*>(drow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc = fmaf(__bfloat162float(oe[e]), __bfloat162float(de[e]), acc);
      }
    }
    // parts (0 + 1) (+ (2 + 3)): a + b == b + a, so every lane of the row
    // ends with the same bits
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (TPR == 4) acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const float l = pos < a.lq
          ? a.lse_in[((long long)b * a.hq + h) * a.lq + pos] : INFINITY;
      lse_s[r] = l;
      dd_s[r] = acc;
      const long long at = ((long long)b * a.hq + h) * a.lq_pad + pos;
      a.lse[at] = l;
      a.dd[at] = acc;
    }
  }
  mbar_wait(qbar, 0);
  __syncthreads();  // lse and D of every row visible

  const int blk = SPLIT ? 0 : wg;   // this warpgroup's 64 rows
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blk * BLK + warp * 16 + g, r1 = r0 + 8;
  const int pos0 = q0 + r0, pos1 = q0 + r1, first = q0 + blk * BLK;
  const float lse0 = lse_s[r0], lse1 = lse_s[r1];
  const float d0 = dd_s[r0], d1 = dd_s[r1];
  const float scale2 = a.scale * LOG2E;
  const unsigned char* qw = qs + blk * TILE;
  const unsigned char* dow = dos + blk * TILE;

  float dq[ACC / 2];
#pragma unroll
  for (int i = 0; i < ACC / 2; ++i) dq[i] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const unsigned char* kt = ring + (t % STAGES) * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    // x: S (SPLIT: this warpgroup's product, S or dP), y: dP
    float x[32], y[32];
    if (SPLIT) {
      ss_product(x, wg == 0 ? qw : dow, wg == 0 ? kt : vt);
    } else {
      ss_product(x, qw, kt);
      ss_product(y, dow, vt);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(x);
    if (!SPLIT) fence_acc(y);
    // P: x[4n + e] is (row r0, key j0 + 8n + 2 t4 + e), x[4n + 2 + e]
    // (r1, ...); rows past Lq have lse +inf, so P is 0 there
    if (!SPLIT || wg == 0) {
      const int j0 = t * BLK;
      const bool edge = j0 + BLK > a.lk ||
                        (a.causal && j0 + BLK - 1 > first + a.kv_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 2) != 0;
        bool ok = true;
        if (edge) {
          const int j = j0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          ok = j < a.lk && (!a.causal || j <= (hi ? pos1 : pos0) + a.kv_offset);
        }
        x[i] = ok ? ex2(x[i] * scale2 - (hi ? lse1 : lse0)) : 0.0f;
      }
    }
    if (SPLIT) swap_halves(x, y, xchg, wg, wt);
    // dS = P (dP - D)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = x[i] * (y[i] - ((i & 2) ? d1 : d0));
    uint32_t dsf[4][4];
    to_frags(y, dsf);
    wgmma_fence();
    cols_product(dq, dsf, kt, wg);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(dsf[kk][r]);
#pragma unroll
    for (int i = 0; i < ACC / 2; ++i) fence_reg(dq[i]);
    __syncthreads();  // the stage (and the exchange) are free
    load_kv(t + STAGES);
  }

  bf16* out = static_cast<bf16*>(a.dq) + ((long long)b * a.hq + h) * a.lq * DH;
  const int cb = SPLIT ? wg * ACC : 0;
#pragma unroll
  for (int n = 0; n < ACC / 8; ++n) {
    const int col = cb + 8 * n + 2 * t4;
    if (col >= DH) continue;
    if (pos0 < a.lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)pos0 * DH + col) =
          __floats2bfloat162_rn(dq[4 * n] * a.scale, dq[4 * n + 1] * a.scale);
    if (pos1 < a.lq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)pos1 * DH + col) =
          __floats2bfloat162_rn(dq[4 * n + 2] * a.scale,
                                dq[4 * n + 3] * a.scale);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv(const Args a, const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv,
              const __grid_constant__ CUtensorMap tmdo) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  unsigned char* ks = smem;                         // [NBLK] K tiles
  unsigned char* vs = ks + NBLK * TILE;             // [NBLK] V tiles
  unsigned char* ring = vs + NBLK * TILE;           // [STAGES][Q, dO]
  float* xchg = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  // [STAGES][lse, D][BLK], 16-byte aligned for the bulk copies
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * TILE + XCHG);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + STAGES * 2 * BLK);
  uint64_t* kbar = full + STAGES;                   // K and V

  const int group = a.hq / a.hkv;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * CTA_ROWS;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = wt >> 5;

  // the query tiles that see a key of this CTA: rows from the first that
  // sees key k0
  const int i_lo = a.causal ? max(0, k0 - a.kv_offset) : 0;
  const int qt_lo = i_lo / BLK;
  const int nq = i_lo < a.lq ? (a.lq + BLK - 1) / BLK - qt_lo : 0;
  const int n_heads = group;  // the group's query heads, each summed in order
  const int n_it = n_heads * nq;

  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kbar, 2 * NBLK * TILE);
    for (int blk = 0; blk < NBLK; ++blk)
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(ks + blk * TILE + cb * 64 * 128, &tmk, 64 * cb,
                 k0 + blk * BLK, hk, b, kbar);
        tma_load(vs + blk * TILE + cb * 64 * 128, &tmv, 64 * cb,
                 k0 + blk * BLK, hk, b, kbar);
      }
  }
  // iteration it: head hk * group + it / nq, query tile qt_lo + it % nq
  auto load_q = [&](int it) {
    if (tid == 0 && it < n_it) {
      const int h = hk * group + it / nq, p0 = (qt_lo + it % nq) * BLK;
      unsigned char* st = ring + (it % STAGES) * 2 * TILE;
      float* sst = stats + (it % STAGES) * 2 * BLK;
      uint64_t* bar = &full[it % STAGES];
      mbar_expect_tx(bar, 2 * TILE + 2 * BLK * 4);
#pragma unroll
      for (int cb = 0; cb < DHP / 64; ++cb) {
        tma_load(st + cb * 64 * 128, &tmq, 64 * cb, p0, h, b, bar);
        tma_load(st + TILE + cb * 64 * 128, &tmdo, 64 * cb, p0, h, b, bar);
      }
      const long long at = ((long long)b * a.hq + h) * a.lq_pad + p0;
      bulk_load(sst, a.lse + at, BLK * 4, bar);
      bulk_load(sst + BLK, a.dd + at, BLK * 4, bar);
    }
  };
  for (int it = 0; it < STAGES; ++it) load_q(it);

  const int blk = SPLIT ? 0 : wg;   // this warpgroup's 64 keys
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + blk * BLK + warp * 16 + g, key1 = key0 + 8;
  const int first_key = k0 + blk * BLK;
  const float scale2 = a.scale * LOG2E;
  const unsigned char* kw = ks + blk * TILE;
  const unsigned char* vw = vs + blk * TILE;
  float dk[ACC / 2], dv[ACC / 2];
#pragma unroll
  for (int i = 0; i < ACC / 2; ++i) dk[i] = dv[i] = 0.0f;
  mbar_wait(kbar, 0);

  for (int it = 0; it < n_it; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    const unsigned char* qt = ring + (it % STAGES) * 2 * TILE;
    const unsigned char* dot = qt + TILE;
    const float* lse_s = stats + (it % STAGES) * 2 * BLK;
    const float* dd_s = lse_s + BLK;
    const int p0 = (qt_lo + it % nq) * BLK;
    // x: S^T (SPLIT: this warpgroup's product, S^T or dP^T), y: dP^T
    float x[32], y[32];
    if (SPLIT) {
      ss_product(x, wg == 0 ? kw : vw, wg == 0 ? qt : dot);
    } else {
      ss_product(x, kw, qt);
      ss_product(y, vw, dot);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(x);
    if (!SPLIT) fence_acc(y);
    // P^T: x[4n + e] is (key0, query p0 + 8n + 2 t4 + e), x[4n + 2 + e]
    // (key1, ...); queries past Lq have lse +inf, so P is 0 there, and
    // keys past Lk are never written
    if (!SPLIT || wg == 0) {
      const bool edge = a.causal && first_key + BLK - 1 > p0 + a.kv_offset;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool ok =
            !edge || ((i & 2) ? key1 : key0) <= p0 + j + a.kv_offset;
        x[i] = ok ? ex2(x[i] * scale2 - lse_s[j]) : 0.0f;
      }
    }
    if (SPLIT) swap_halves(x, y, xchg, wg, wt);
    // dS^T = P^T (dP^T - D)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      y[i] = x[i] * (y[i] - dd_s[8 * (i >> 2) + 2 * t4 + (i & 1)]);
    uint32_t pf[4][4], dsf[4][4];
    to_frags(x, pf);
    to_frags(y, dsf);
    wgmma_fence();
    cols_product(dv, pf, dot, wg);
    cols_product(dk, dsf, qt, wg);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fence_reg(pf[kk][r]);
        fence_reg(dsf[kk][r]);
      }
#pragma unroll
    for (int i = 0; i < ACC / 2; ++i) {
      fence_reg(dk[i]);
      fence_reg(dv[i]);
    }
    __syncthreads();  // the stage (and the exchange) are free
    load_q(it + STAGES);
  }

  const long long base = ((long long)b * a.hkv + hk) * a.lk;
  bf16* gk = static_cast<bf16*>(a.dk) + base * DH;
  bf16* gv = static_cast<bf16*>(a.dv) + base * DH;
  const int cb = SPLIT ? wg * ACC : 0;
#pragma unroll
  for (int n = 0; n < ACC / 8; ++n) {
    const int col = cb + 8 * n + 2 * t4;
    if (col >= DH) continue;
    if (key0 < a.lk) {
      *reinterpret_cast<__nv_bfloat162*>(gk + (long long)key0 * DH + col) =
          __floats2bfloat162_rn(dk[4 * n] * a.scale, dk[4 * n + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + (long long)key0 * DH + col) =
          __floats2bfloat162_rn(dv[4 * n], dv[4 * n + 1]);
    }
    if (key1 < a.lk) {
      *reinterpret_cast<__nv_bfloat162*>(gk + (long long)key1 * DH + col) =
          __floats2bfloat162_rn(dk[4 * n + 2] * a.scale,
                                dk[4 * n + 3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(gv + (long long)key1 * DH + col) =
          __floats2bfloat162_rn(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// The two launches of one call: dQ (and the lse/D scratch), then dK/dV.
// Refuses a call whose shared memory is not what this source lays out
// (the wrapper's plan must agree with it).
extern "C" int launch(const Args* a, void* stream) {
  if (a->smem_dq != SMEM_DQ || a->smem_dkv != SMEM_DKV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tmq, tmk, tmv, tmdo;
  int err = tensor_map(&tmq, a->q, DH, a->lq, a->hq, a->b, a->qsl, a->qsh,
                       a->qsb);
  if (!err) err = tensor_map(&tmk, a->k, DH, a->lk, a->hkv, a->b, a->ksl,
                             a->ksh, a->ksb);
  if (!err) err = tensor_map(&tmv, a->v, DH, a->lk, a->hkv, a->b, a->vsl,
                             a->vsh, a->vsb);
  if (!err) err = tensor_map(&tmdo, a->dout, DH, a->lq, a->hq, a->b, a->dsl,
                             a->dsh, a->dsb);
  if (err) return err;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_DKV);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const dim3 gq(a->lq_pad / CTA_ROWS, a->hq, a->b);
  flash_bwd_dq<<<gq, THREADS, SMEM_DQ, st>>>(*a, tmq, tmk, tmv, tmdo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gk((a->lk + CTA_ROWS - 1) / CTA_ROWS, a->hkv, a->b);
  flash_bwd_dkv<<<gk, THREADS, SMEM_DKV, st>>>(*a, tmq, tmk, tmv, tmdo);
  return (int)cudaGetLastError();
}

// What this build lays out: {SMEM_DQ, SMEM_DKV, CTA_ROWS, BLK, STAGES,
// THREADS, SPLIT}.
extern "C" int layout(int* out) {
  const int v[7] = {SMEM_DQ, SMEM_DKV, CTA_ROWS, BLK, STAGES, THREADS,
                    (int)SPLIT};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
