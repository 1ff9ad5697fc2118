// Chunkwise mLSTM (xLSTM matrix memory): forward and backward.
//
// Replaces: src/repro/kernels/mlstm.py:mlstm_chunked (pallas_call at :102,
// body _kernel :34).  The training path's gradient, which the reference
// gets by autodiff of the plain scan, is the backward kernel here.
//
// Math (per (batch, head), per chunk of W rows, f32, q pre-scaled):
//   cum_t = sum_{s<=t} logf_s, total = cum_{W-1}
//   dmat[t,s] = cum_t - cum_s + logi_s (s <= t), m_t = max(max_s dmat, cum_t)
//   att = (q k^T) * exp(dmat - m), dec_t = exp(cum_t - m_t)
//   num = att v + dec * (q C),  den = rowsum(att) + dec * (q . n)
//   out = num / g,  g = max(|den|, exp(-m))
//   C' = e^total C + sum_s e^(total - cum_s + logi_s) k_s v_s^T, n' likewise.
//
// Bound: operations.  Per chunk the products q k^T (causal half), att v,
// q C and the state update k^T v are O(W^2 Dh + W Dh^2) f32 multiply-adds
// against O(W Dh) bytes of q/k/v/out; at Dh 256, W 64 that is ~38 flops per
// byte, above the card's f32 ratio (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design.  The TPU kernel keeps the whole C [Dh, Dh] f32 in VMEM across the
// sequential chunk grid; at Dh 256 that is 256 KiB, more than one CTA's
// shared memory (227 KiB).  Here one CTA owns (batch*head, a tile of TV
// value columns) and loops over the chunks itself: out[:, tile] and
// C[:, tile] depend only on that tile, while att, den and n, which need the
// full q and k, every CTA recomputes (at Dh 256, TV 64: 4x the q k^T work,
// 128 CTAs on 132 SMs instead of 32).  C[:, tile] ([Dh, TV], 64 KiB) and n
// stay in shared memory across the chunk loop; q and k stream through in
// Dh slices of DS columns, and one pass over the slices accumulates q k^T,
// q C[:, tile] and q . n and then updates that slice of C and n.  Products
// run on the CUDA cores (fmaf, one thread owns a 4x4-ish register tile);
// wgmma/TMA is later work.  Masked pairs s > t are skipped in every
// product over a chunk's pairs except the q k^T register tile, which covers
// the whole W x W square.  Sums run in a fixed order with no atomics, so
// two runs are bit-equal.
//
// Backward.  m_row is held constant: num, den and the clamp floor exp(-m)
// all carry the factor exp(-m), so out does not depend on the stabiliser
// and its gradient through m is zero (the reference's autodiff routes a
// gradient through the max that cancels to rounding).  The CTA walks the
// chunks in reverse, carrying dC[:, tile] (shared memory) and dn (tile 0
// only, the one tile that adds the terms that need it), and recomputes the
// chunk's forward from the chunk-entry states C, n that the forward saved.
// A row pass first forms dden_t = -[|den| >= e^-m] sign(den) sum_v dout*out
// / g over ALL value columns (from the saved out), then the tile pass:
//   datt = dnum v^T (+ dden, tile 0), dS = datt * P, ddmat = datt * att
//   dv = att^T dnum + wgt * (k dC)                       (column-local)
//   dq = dS k + dec * dnum C^T (+ dec dden n, tile 0)    (per-tile partial)
//   dk = dS^T q + wgt * (dC v^T) (+ wgt dn, tile 0)      (per-tile partial)
//   dC <- e^total dC + (dec q)^T dnum,  dn <- e^total dn + (dec q)^T dden
// and the gate gradients through cumsum as reverse cumsums in the chunk.
// dq, dk, dlogi, dlogf are written per tile and summed over the tiles in
// ascending order by mlstm_sum_tiles: no float atomics.
#include <cuda_runtime.h>
#include <math.h>

//@GENERATED@

#define NT 256                 // threads per CTA: a 16 x 16 grid
#define DS 16                  // Dh slice streamed through shared memory
#define QS (DS + 1)            // padded row stride of the q/k slices
#define RT (W / 16)            // chunk rows (and columns) per thread
#define VC (TV / 16)           // value columns per thread
#define AW (W + 1)             // padded row stride of W x W tiles
#define TVP (TV + 1)           // padded row stride of W x TV and Dh x TV tiles

// Each kernel's dynamic shared memory is laid out at its top; the
// launchers take its size from kernels/mlstm.py:smem_bytes, which also
// chooses TV.

// The chunk's gate quantities, the same code in both kernels so the
// backward recomputes the forward's values bit for bit.
__device__ __forceinline__ void chunk_gates(
    const float* __restrict__ logi, const float* __restrict__ logf,
    long long row0, float* li, float* cum, float* m, float* dec, float* wgt,
    float* total) {
  const int tid = threadIdx.x;
  if (tid < W) {
    li[tid] = logi[row0 + tid];
    cum[tid] = logf[row0 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f;
    for (int t = 0; t < W; ++t) { a = a + cum[t]; cum[t] = a; }
    *total = a;
  }
  __syncthreads();
  if (tid < W) {
    const float ct = cum[tid];
    float mx = -INFINITY;
    for (int s = 0; s <= tid; ++s) mx = fmaxf(mx, (ct - cum[s]) + li[s]);
    const float mt = fmaxf(mx, ct);
    m[tid] = mt;
    dec[tid] = expf(ct - mt);
    wgt[tid] = expf((*total - ct) + li[tid]);
  }
  __syncthreads();
}

// Stage q and k rows [row0, row0 + W) x [d0, d0 + DS) (zero past D).
__device__ __forceinline__ void load_slice(
    const float* __restrict__ a, const float* __restrict__ b, long long row0,
    int d0, int D, float* as, float* bs) {
  for (int i = threadIdx.x; i < W * DS; i += NT) {
    const int s = i / DS, dd = i % DS, d = d0 + dd;
    const long long g = (row0 + s) * D + d;
    as[s * QS + dd] = d < D ? a[g] : 0.0f;
    bs[s * QS + dd] = d < D ? b[g] : 0.0f;
  }
}

// One pass over the Dh slices: S = q k^T (registers, rows ty+16r, cols
// tx+16c), I = q C[:, tile] (rows ty+16r, value cols tx+16j), qn = q . n.
// With `update`, each slice of C and n is then advanced to the next
// chunk's entry state (the forward); the backward passes false.
__device__ __forceinline__ void slice_pass(
    const float* __restrict__ q, const float* __restrict__ k, long long row0,
    int D, float* Cs, float* ns, const float* vs, const float* wgt,
    float e_total, float* qs, float* ks, float* qn, float (&S)[RT][RT],
    float (&I)[RT][VC], bool update) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < RT; ++c) S[r][c] = 0.0f;
#pragma unroll
    for (int j = 0; j < VC; ++j) I[r][j] = 0.0f;
  }
  float qn_acc = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DS) {
    load_slice(q, k, row0, d0, D, qs, ks);
    __syncthreads();
    const int dn = min(DS, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      float a[RT], b[RT], cv[VC];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        a[r] = qs[(ty + 16 * r) * QS + dd];
        b[r] = ks[(tx + 16 * r) * QS + dd];
      }
#pragma unroll
      for (int j = 0; j < VC; ++j) cv[j] = Cs[(d0 + dd) * TVP + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < RT; ++c) S[r][c] = fmaf(a[r], b[c], S[r][c]);
#pragma unroll
        for (int j = 0; j < VC; ++j) I[r][j] = fmaf(a[r], cv[j], I[r][j]);
      }
    }
    if (tid < W)
      for (int dd = 0; dd < dn; ++dd)
        qn_acc = fmaf(qs[tid * QS + dd], ns[d0 + dd], qn_acc);
    __syncthreads();
    if (update) {
      for (int i = tid; i < dn * TV; i += NT) {
        const int dd = i / TV, vv = i % TV;
        float acc = 0.0f;
        for (int s = 0; s < W; ++s)
          acc = fmaf(ks[s * QS + dd] * wgt[s], vs[s * TVP + vv], acc);
        float* c = Cs + (d0 + dd) * TVP + vv;
        *c = fmaf(e_total, *c, acc);
      }
      if (tid < dn) {
        float acc = 0.0f;
        for (int s = 0; s < W; ++s) acc = fmaf(ks[s * QS + tid], wgt[s], acc);
        ns[d0 + tid] = fmaf(e_total, ns[d0 + tid], acc);
      }
      __syncthreads();
    }
  }
  if (tid < W) qn[tid] = qn_acc;
  __syncthreads();
}

// att = S * P (masked entries 0) into registers and shared memory, and
// den, g per row.  P kept in registers for the backward.
__device__ __forceinline__ void chunk_att(
    const float (&S)[RT][RT], const float* li, const float* cum,
    const float* m, const float* dec, const float* qn, float* att,
    float* den, float* g, float (&A)[RT][RT], float (&P)[RT][RT]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int t = ty + 16 * r;
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int s = tx + 16 * c;
      float p = 0.0f;
      if (s <= t) p = expf(((cum[t] - cum[s]) + li[s]) - m[t]);
      P[r][c] = p;
      A[r][c] = S[r][c] * p;
      att[t * AW + s] = A[r][c];
      rs += A[r][c];
    }
    // the 16 lanes of a row: a butterfly, bit-identical in every lane
    for (int o = 8; o; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (tx == 0) {
      const float dn = rs + dec[t] * qn[t];
      den[t] = dn;
      g[t] = fmaxf(fabsf(dn), expf(-m[t]));
    }
  }
  __syncthreads();
}

extern "C" __global__ void __launch_bounds__(NT) mlstm_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logi,
    const float* __restrict__ logf, float* __restrict__ out,
    float* __restrict__ c_st, float* __restrict__ n_st, int L, int D) {
  extern __shared__ float sm[];
  const int tile = blockIdx.x, v0 = tile * TV;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = L / W;
  float* Cs = sm;                      // [D][TVP]
  float* ns = Cs + D * TVP;            // [D]
  float* vs = ns + D;                  // [W][TVP]
  float* att = vs + W * TVP;           // [W][AW]
  float* qs = att + W * AW;            // [W][QS]
  float* ks = qs + W * QS;             // [W][QS]
  float* li = ks + W * QS;             // [W] each
  float* cum = li + W;
  float* m = cum + W;
  float* dec = m + W;
  float* wgt = dec + W;
  float* qn = wgt + W;
  float* den = qn + W;
  float* g = den + W;
  float* total = g + W;                // [1]

  for (int i = tid; i < D * TVP; i += NT) Cs[i] = 0.0f;
  for (int i = tid; i < D; i += NT) ns[i] = 0.0f;
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const long long row0 = bh * L + (long long)c * W;
    if (c_st) {   // the chunk-entry state, kept for the backward
      float* cd = c_st + (bh * nc + c) * (long long)D * D;
      for (int i = tid; i < D * TV; i += NT) {
        const int d = i / TV, vv = i % TV;
        if (v0 + vv < D) cd[(long long)d * D + v0 + vv] = Cs[d * TVP + vv];
      }
      if (tile == 0)
        for (int d = tid; d < D; d += NT) n_st[(bh * nc + c) * D + d] = ns[d];
    }
    for (int i = tid; i < W * TV; i += NT) {
      const int s = i / TV, vv = i % TV;
      vs[s * TVP + vv] = v0 + vv < D ? v[(row0 + s) * D + v0 + vv] : 0.0f;
    }
    chunk_gates(logi, logf, row0, li, cum, m, dec, wgt, total);
    float S[RT][RT], I[RT][VC], A[RT][RT], P[RT][RT];
    slice_pass(q, k, row0, D, Cs, ns, vs, wgt, expf(*total), qs, ks, qn, S,
               I, true);
    chunk_att(S, li, cum, m, dec, qn, att, den, g, A, P);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        const int vv = tx + 16 * j;
        float acc = 0.0f;
        for (int s = 0; s <= t; ++s)
          acc = fmaf(att[t * AW + s], vs[s * TVP + vv], acc);
        const float num = acc + dec[t] * I[r][j];
        if (v0 + vv < D) out[(row0 + t) * D + v0 + vv] = num / g[t];
      }
    }
    __syncthreads();
  }
}

extern "C" __global__ void __launch_bounds__(NT) mlstm_bwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logi,
    const float* __restrict__ logf, const float* __restrict__ out,
    const float* __restrict__ dout, const float* __restrict__ c_st,
    const float* __restrict__ n_st, float* __restrict__ dq_p,
    float* __restrict__ dk_p, float* __restrict__ dv,
    float* __restrict__ dli_p, float* __restrict__ dlf_p, int L, int D,
    int BH) {
  extern __shared__ float sm[];
  const int tile = blockIdx.x, v0 = tile * TV;
  const bool first = tile == 0;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = L / W;
  const long long part = (long long)tile * BH * L;    // this tile's partials
  float* Cs = sm;                      // [D][TVP] chunk-entry C[:, tile]
  float* dCs = Cs + D * TVP;           // [D][TVP] cotangent of C leaving
  float* ns = dCs + D * TVP;           // [D]
  float* dn = ns + D;                  // [D] (tile 0)
  float* vs = dn + D;                  // [W][TVP]
  float* dnum = vs + W * TVP;          // [W][TVP]
  float* att = dnum + W * TVP;         // [W][AW]
  float* dS = att + W * AW;            // [W][AW]
  float* qs = dS + W * AW;             // [W][QS]
  float* ks = qs + W * QS;             // [W][QS]
  float* dCv = ks + W * QS;            // [W][QS]
  float* li = dCv + W * QS;            // [W] each, 15 of them
  float* cum = li + W;
  float* m = cum + W;
  float* dec = m + W;
  float* wgt = dec + W;
  float* qn = wgt + W;
  float* den = qn + W;
  float* g = den + W;
  float* rowdot = g + W;
  float* dden = rowdot + W;
  float* ddec = dden + W;
  float* dwgt = ddec + W;
  float* rowdd = dwgt + W;
  float* coldd = rowdd + W;
  float* dcum = coldd + W;
  float* red = dcum + W;               // [NT]
  float* cred = red + NT;              // [16][W]
  float* total = cred + 16 * W;        // [1], then dE, dtotal

  for (int i = tid; i < D * TVP; i += NT) dCs[i] = 0.0f;
  for (int i = tid; i < D; i += NT) dn[i] = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long row0 = bh * L + (long long)c * W;
    const float* cd = c_st + (bh * nc + c) * (long long)D * D;
    for (int i = tid; i < D * TV; i += NT) {
      const int d = i / TV, vv = i % TV;
      Cs[d * TVP + vv] = v0 + vv < D ? cd[(long long)d * D + v0 + vv] : 0.0f;
    }
    for (int d = tid; d < D; d += NT) ns[d] = n_st[(bh * nc + c) * D + d];
    for (int i = tid; i < W * TV; i += NT) {
      const int s = i / TV, vv = i % TV;
      const bool ok = v0 + vv < D;
      vs[s * TVP + vv] = ok ? v[(row0 + s) * D + v0 + vv] : 0.0f;
      dnum[s * TVP + vv] = ok ? dout[(row0 + s) * D + v0 + vv] : 0.0f;
    }
    // row pass: sum_v dout * out over all value columns, one warp a row
    for (int t = warp; t < W; t += NT / 32) {
      float acc = 0.0f;
      for (int vv = lane; vv < D; vv += 32)
        acc = fmaf(dout[(row0 + t) * D + vv], out[(row0 + t) * D + vv], acc);
      for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) rowdot[t] = acc;
    }
    chunk_gates(logi, logf, row0, li, cum, m, dec, wgt, total);
    const float e_total = expf(*total);
    float S[RT][RT], I[RT][VC], A[RT][RT], P[RT][RT];
    slice_pass(q, k, row0, D, Cs, ns, vs, wgt, e_total, qs, ks, qn, S, I,
               false);
    chunk_att(S, li, cum, m, dec, qn, att, den, g, A, P);
    if (tid < W) {
      const float dd = den[tid], em = expf(-m[tid]);
      const float sg = dd > 0.0f ? 1.0f : (dd < 0.0f ? -1.0f : 0.0f);
      dden[tid] = fabsf(dd) >= em ? -sg * rowdot[tid] / g[tid] : 0.0f;
    }
    for (int i = tid; i < W * TV; i += NT) {
      const int s = i / TV, vv = i % TV;
      dnum[s * TVP + vv] = dnum[s * TVP + vv] / g[s];
    }
    __syncthreads();
    // datt, dS, ddmat row and column sums
    float cdd[RT];
#pragma unroll
    for (int c2 = 0; c2 < RT; ++c2) cdd[c2] = 0.0f;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int t = ty + 16 * r;
      float rdd = 0.0f;
#pragma unroll
      for (int c2 = 0; c2 < RT; ++c2) {
        const int s = tx + 16 * c2;
        float ds = 0.0f;
        if (s <= t) {
          float da = 0.0f;
          for (int vv = 0; vv < TV; ++vv)
            da = fmaf(dnum[t * TVP + vv], vs[s * TVP + vv], da);
          if (first) da += dden[t];
          ds = da * P[r][c2];
          const float dm = da * A[r][c2];
          rdd += dm;
          cdd[c2] += dm;
        }
        dS[t * AW + s] = ds;
      }
      for (int o = 8; o; o >>= 1) rdd += __shfl_xor_sync(0xffffffffu, rdd, o);
      if (tx == 0) rowdd[t] = rdd;
      // ddec_t = dnum_t . (q C)_t over the tile (+ dden qn, tile 0)
      float de = 0.0f;
#pragma unroll
      for (int j = 0; j < VC; ++j)
        de = fmaf(dnum[t * TVP + tx + 16 * j], I[r][j], de);
      for (int o = 8; o; o >>= 1) de += __shfl_xor_sync(0xffffffffu, de, o);
      if (tx == 0) ddec[t] = first ? de + dden[t] * qn[t] : de;
    }
#pragma unroll
    for (int c2 = 0; c2 < RT; ++c2) cred[ty * W + tx + 16 * c2] = cdd[c2];
    __syncthreads();
    if (tid < W) {
      float a = 0.0f;
      for (int y = 0; y < 16; ++y) a += cred[y * W + tid];
      coldd[tid] = a;
    }
    // dv, intra part: rows s = ty+16r, value cols tx+16j
    float dvacc[RT][VC];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int s = ty + 16 * r;
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        const int vv = tx + 16 * j;
        float acc = 0.0f;
        for (int t = s; t < W; ++t)
          acc = fmaf(att[t * AW + s], dnum[t * TVP + vv], acc);
        dvacc[r][j] = acc;
      }
    }
    // slice pass B: dq, dk partials, dv carry part, dwgt, dE, dC and dn
    float dwgt_acc = 0.0f, de_acc = 0.0f;
    for (int d0 = 0; d0 < D; d0 += DS) {
      const int dnw = min(DS, D - d0);
      load_slice(q, k, row0, d0, D, qs, ks);
      __syncthreads();
      {
        const int dd = tid & 15;
        const int d = d0 + dd;
        for (int r = 0; r < RT; ++r) {
          const int s = (tid >> 4) + 16 * r;
          float acc = 0.0f;
          for (int vv = 0; vv < TV; ++vv)
            acc = fmaf(dCs[d * TVP + vv], vs[s * TVP + vv], acc);
          dCv[s * QS + dd] = dd < dnw ? acc : 0.0f;
        }
      }
      __syncthreads();
      {
        const int dd = tid & 15;
        const int d = d0 + dd;
        for (int r = 0; r < RT; ++r) {
          const int t = (tid >> 4) + 16 * r;   // dq row t, dk row t
          float aq = 0.0f;
          for (int s = 0; s <= t; ++s)
            aq = fmaf(dS[t * AW + s], ks[s * QS + dd], aq);
          float ac = 0.0f;
          for (int vv = 0; vv < TV; ++vv)
            ac = fmaf(Cs[d * TVP + vv], dnum[t * TVP + vv], ac);
          aq = aq + dec[t] * ac;
          float ak = 0.0f;
          for (int t2 = t; t2 < W; ++t2)
            ak = fmaf(dS[t2 * AW + t], qs[t2 * QS + dd], ak);
          ak = ak + wgt[t] * dCv[t * QS + dd];
          if (first) {
            aq = aq + (dec[t] * dden[t]) * ns[d];
            ak = ak + wgt[t] * dn[d];
          }
          if (dd < dnw) {
            const long long o = part * D + (row0 + t) * D + d;
            dq_p[o] = aq;
            dk_p[o] = ak;
          }
        }
      }
      if (tid < W) {
        for (int dd = 0; dd < dnw; ++dd) {
          float x = dCv[tid * QS + dd];
          if (first) x = x + dn[d0 + dd];
          dwgt_acc = fmaf(ks[tid * QS + dd], x, dwgt_acc);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int s = ty + 16 * r;
#pragma unroll
        for (int j = 0; j < VC; ++j) {
          const int vv = tx + 16 * j;
          float acc = 0.0f;
          for (int dd = 0; dd < dnw; ++dd)
            acc = fmaf(ks[s * QS + dd], dCs[(d0 + dd) * TVP + vv], acc);
          dvacc[r][j] = fmaf(wgt[s], acc, dvacc[r][j]);
        }
      }
      for (int i = tid; i < dnw * TV; i += NT) {
        const int dd = i / TV, vv = i % TV;
        de_acc = fmaf(dCs[(d0 + dd) * TVP + vv], Cs[(d0 + dd) * TVP + vv],
                      de_acc);
      }
      if (first && tid < dnw) de_acc = fmaf(dn[d0 + tid], ns[d0 + tid], de_acc);
      __syncthreads();
      // the carried cotangents, now for the state entering this chunk
      for (int i = tid; i < dnw * TV; i += NT) {
        const int dd = i / TV, vv = i % TV;
        float acc = 0.0f;
        for (int t = 0; t < W; ++t)
          acc = fmaf(dec[t] * qs[t * QS + dd], dnum[t * TVP + vv], acc);
        float* x = dCs + (d0 + dd) * TVP + vv;
        *x = fmaf(e_total, *x, acc);
      }
      if (first && tid < dnw) {
        float acc = 0.0f;
        for (int t = 0; t < W; ++t)
          acc = fmaf(dec[t] * dden[t], qs[t * QS + tid], acc);
        dn[d0 + tid] = fmaf(e_total, dn[d0 + tid], acc);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int s = ty + 16 * r;
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        const int vv = tx + 16 * j;
        if (v0 + vv < D) dv[(row0 + s) * D + v0 + vv] = dvacc[r][j];
      }
    }
    red[tid] = de_acc;
    if (tid < W) dwgt[tid] = dwgt_acc;
    __syncthreads();
    if (tid == 0) {
      float de = 0.0f;
      for (int i = 0; i < NT; ++i) de += red[i];
      float dt = 0.0f;
      for (int s = 0; s < W; ++s) dt += dwgt[s] * wgt[s];
      total[2] = dt + de * e_total;          // d total
    }
    __syncthreads();
    if (tid < W) {
      const float dw = dwgt[tid] * wgt[tid];
      dli_p[part + row0 + tid] = coldd[tid] + dw;
      float dc = ((rowdd[tid] - coldd[tid]) + ddec[tid] * dec[tid]) - dw;
      if (tid == W - 1) dc += total[2];
      dcum[tid] = dc;
    }
    __syncthreads();
    if (tid == 0) {   // through cumsum: a reverse cumsum within the chunk
      float a = 0.0f;
      for (int t = W - 1; t >= 0; --t) {
        a = a + dcum[t];
        dlf_p[part + row0 + t] = a;
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over tiles of p[tile][i], tiles in ascending order.
extern "C" __global__ void mlstm_sum_tiles(const float* __restrict__ p,
                                           float* __restrict__ out,
                                           long long n, int nt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = p[i];
  for (int t = 1; t < nt; ++t) a = a + p[(long long)t * n + i];
  out[i] = a;
}

static int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" int launch_fwd(const void* q, const void* k, const void* v,
                          const void* logi, const void* logf, void* out,
                          void* c_st, void* n_st, int BH, int L, int D,
                          int smem, void* stream) {
  int err = set_smem((const void*)mlstm_fwd, smem);
  if (err) return err;
  dim3 grid((D + TV - 1) / TV, BH);
  mlstm_fwd<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)logi,
      (const float*)logf, (float*)out, (float*)c_st, (float*)n_st, L, D);
  return (int)cudaGetLastError();
}

extern "C" int launch_bwd(const void* q, const void* k, const void* v,
                          const void* logi, const void* logf, const void* out,
                          const void* dout, const void* c_st,
                          const void* n_st, void* dq_p, void* dk_p,
                          void* dli_p, void* dlf_p, void* dq, void* dk,
                          void* dv, void* dlogi, void* dlogf, int BH, int L,
                          int D, int smem, void* stream) {
  int err = set_smem((const void*)mlstm_bwd, smem);
  if (err) return err;
  const int nt = (D + TV - 1) / TV;
  dim3 grid(nt, BH);
  cudaStream_t st = (cudaStream_t)stream;
  mlstm_bwd<<<grid, NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)logi,
      (const float*)logf, (const float*)out, (const float*)dout,
      (const float*)c_st, (const float*)n_st, (float*)dq_p, (float*)dk_p,
      (float*)dv, (float*)dli_p, (float*)dlf_p, L, D, BH);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long nqk = (long long)BH * L * D, ng = (long long)BH * L;
  const int th = 256;
  mlstm_sum_tiles<<<(unsigned)((nqk + th - 1) / th), th, 0, st>>>(
      (const float*)dq_p, (float*)dq, nqk, nt);
  mlstm_sum_tiles<<<(unsigned)((nqk + th - 1) / th), th, 0, st>>>(
      (const float*)dk_p, (float*)dk, nqk, nt);
  mlstm_sum_tiles<<<(unsigned)((ng + th - 1) / th), th, 0, st>>>(
      (const float*)dli_p, (float*)dlogi, ng, nt);
  mlstm_sum_tiles<<<(unsigned)((ng + th - 1) / th), th, 0, st>>>(
      (const float*)dlf_p, (float*)dlogf, ng, nt);
  return (int)cudaGetLastError();
}
