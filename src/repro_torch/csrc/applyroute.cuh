// The route-range table of the fused Pregel apply (apply.cu); it is built
// and specified in kernels/applyroute.py.
//
//   apply_rng[q, pe, b] (int32, [P, P, NB + 1], NB = ceil(V_blk / APPLY_GRAN))
//   is the first entry j of the live prefix of route row send[q, pe, :]
//   whose home slot is >= b * APPLY_GRAN; apply_rng[q, pe, NB] is the live
//   count.  The live prefix is strictly increasing in the home slot, so the
//   entries of home slots [b0 * APPLY_GRAN, b1 * APPLY_GRAN) are the span
//   [apply_rng[q, pe, b0], apply_rng[q, pe, b1]), and within one pe no two
//   entries share a slot.
#define APPLY_GRAN 64
