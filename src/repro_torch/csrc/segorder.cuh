// The summation order of the port's CSR segment reductions (triplet.cu,
// segment_sum.cu), and the two passes that follow it.  This comment is the
// specification; kernels/ref.py:ordered_segment_reduce is its plain PyTorch
// model, which the card checks hold both kernels to bit for bit.
//
//   * A segment is one aggregation slot's CSR range [ptr[v], ptr[v+1]).  It
//     is cut into pieces at the fixed offsets ptr[v] + k * SEG_PIECE; a
//     segment no longer than SEG_PIECE is one piece (an empty one too).
//   * The cut reads the structure (ptr) alone, never the live mask: the
//     piece tables (kernels/segorder.py) are built once per graph, and
//     skipStale changes only which terms are skipped.
//   * Within a piece, the live terms are combined sequentially in ascending
//     CSR position, starting from the reduce identity.  A dead term is
//     skipped, not added as 0 (a sum whose only live term is -0.0 reads
//     +0.0 + -0.0 = +0.0, as before).
//   * The piece partials of a segment are combined sequentially in
//     ascending piece order, starting from the first piece's partial.
//   * The live count is an integer sum; min and max are exact in any order.
//   * No float atomics, and no tree whose shape the launch chooses.
//
// For a segment of at most SEG_PIECE positions this is the plain sequential
// order of the one-thread-per-slot kernels it replaced.
//
// Pass 1 (seg_pieces): a warp takes 32 consecutive pieces of one partition,
// which cover one contiguous CSR span.  It walks the span in windows of WIN
// positions: lane l stages positions l, l + 32, ... of the window (reads the
// index streams coalesced, skips dead terms, computes the term once) into
// shared memory; then each lane combines the positions of its own piece
// that fall in the window, in ascending order.  No lane combines more than
// SEG_PIECE positions, so a hub is spread over ceil(deg / SEG_PIECE) lanes.
// A single-piece segment writes its slot; a later piece of a longer segment
// writes its partial to a scratch row, and the first piece writes the slot.
// Pass 2 (seg_combine): one warp per segment of several pieces combines the
// slot with its scratch rows in piece order, 32 rows a load.
#include <climits>

#define SEG_PIECE 32

// Pieces of partition q: seg[q * np + k] is piece k's segment (-1 past the
// last), ptr/pptr [nl, v + 1] the segments' CSR ranges and first pieces.
// Piece k > pptr[s] of segment s has scratch row q * (np - v) + k - s - 1.
__device__ __forceinline__ long long seg_row(int q, int np, int v, int k,
                                             int s) {
  return (long long)q * (np - v) + k - s - 1;
}

template <int DM>
struct SegShape {
  // window positions per warp: shared memory WIN * (4 DM + 1) bytes a warp,
  // at most 48 KiB a block of WARPS warps
  static constexpr int WIN = DM <= 8 ? 256 : DM <= 16 ? 128 : DM <= 32 ? 64
                                                                        : 32;
  static constexpr int FIT = 48 * 1024 / (WIN * (4 * DM + 1));
  static constexpr int WARPS = FIT < 4 ? FIT : 4;
  static_assert(WARPS >= 1, "a message of more than 383 f32 columns");
};

// One warp's pieces.  Stage: bool operator()(int q, int pos, float* m)
// writes the term of CSR position pos of partition q into m[DM] and returns
// its live bit (false: dead, m untouched).  Op: ident() and op(acc, term).
// out/cnt rows are `stride` floats apart (cnt, part_cnt may be null).
template <int DM, class Op, class Stage>
__device__ __forceinline__ void seg_pieces(
    const Stage& stage, const int* __restrict__ ptr,
    const int* __restrict__ pptr, const int* __restrict__ pseg, int v,
    int np, long long gw, float* __restrict__ out, float* __restrict__ cnt,
    long long stride, float* __restrict__ part, int* __restrict__ part_cnt,
    float* sm, unsigned char* sl) {
  constexpr int WIN = SegShape<DM>::WIN;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int wpp = np / 32;
  const int q = (int)(gw / wpp);
  const int k = (int)(gw % wpp) * 32 + lane;
  const int* rp = ptr + (long long)q * (v + 1);
  const int* pp = pptr + (long long)q * (v + 1);
  const int s = pseg[(long long)q * np + k];
  int k0 = 0, b = INT_MAX, e = 0;
  if (s >= 0) {
    k0 = pp[s];
    b = rp[s] + (k - k0) * SEG_PIECE;
    e = min(b + SEG_PIECE, rp[s + 1]);
  }
  const int lo = __reduce_min_sync(full, b);
  const int hi = __reduce_max_sync(full, e);
  if (lo == INT_MAX) return;  // the partition's pieces ended before this warp
  float acc[DM];
#pragma unroll
  for (int c = 0; c < DM; ++c) acc[c] = Op::ident();
  int n = 0;
  for (int w0 = lo; w0 < hi; w0 += WIN) {
    const int w1 = min(w0 + WIN, hi);
    for (int p = w0 + lane; p < w1; p += 32) {
      float m[DM];
      const bool live = stage(q, p, m);
      sl[p - w0] = live;
      if (live) {
#pragma unroll
        for (int c = 0; c < DM; ++c) sm[(p - w0) * DM + c] = m[c];
      }
    }
    __syncwarp();
    const int i1 = min(e, w1);
    for (int p = max(b, w0); p < i1; ++p) {
      if (sl[p - w0]) {
#pragma unroll
        for (int c = 0; c < DM; ++c)
          acc[c] = Op::op(acc[c], sm[(p - w0) * DM + c]);
        ++n;
      }
    }
    __syncwarp();
  }
  if (s < 0) return;
  if (k == k0) {
    const long long slot = (long long)q * v + s;
#pragma unroll
    for (int c = 0; c < DM; ++c) out[slot * stride + c] = acc[c];
    if (cnt) cnt[slot] = (float)n;
  } else {
    const long long row = seg_row(q, np, v, k, s);
#pragma unroll
    for (int c = 0; c < DM; ++c) part[row * stride + c] = acc[c];
    if (part_cnt) part_cnt[row] = n;
  }
}

// Pass 2, warp gw of nm: segment multi[gw], every column.  The lanes load
// 32 partials at a time (coalesced along the scratch rows) and every lane
// adds them to its copy of the sum in piece order through shuffles, so the
// chain of adds is the contract's and only it is serial.
template <class Op>
__device__ __forceinline__ void seg_combine(
    long long gw, const int* __restrict__ multi, int nm, int cols,
    const int* __restrict__ pptr, int v, int np, float* __restrict__ out,
    float* __restrict__ cnt, long long stride,
    const float* __restrict__ part, const int* __restrict__ part_cnt) {
  if (gw >= nm) return;  // warp-uniform
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int gs = multi[gw];
  const int q = gs / v, s = gs % v;
  const int* pp = pptr + (long long)q * (v + 1);
  const int k0 = pp[s], n = pp[s + 1] - k0 - 1;  // partials after the first
  const long long row0 = seg_row(q, np, v, k0 + 1, s);
  for (int col = 0; col < cols; ++col) {
    float acc = out[(long long)gs * stride + col];
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const float p = j < n ? part[(row0 + j) * stride + col] : 0.0f;
      const int m = min(32, n - j0);
      for (int i = 0; i < m; ++i) acc = Op::op(acc, __shfl_sync(full, p, i));
    }
    if (lane == 0) out[(long long)gs * stride + col] = acc;
  }
  if (cnt) {
    int tot = 0;
    for (int j = lane; j < n; j += 32) tot += part_cnt[row0 + j];
    tot = __reduce_add_sync(full, tot);
    if (lane == 0) cnt[gs] = (float)((int)cnt[gs] + tot);
  }
}
