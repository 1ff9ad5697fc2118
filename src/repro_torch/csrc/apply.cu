// Fused Pregel apply: combine the routed aggregates of each home vertex,
// substitute the default message, run the vprog, select on visibility and
// derive the changed bit — one thread per home slot, one pass.
//
// Replaces: src/repro/kernels/superstep.py:fused_apply (pallas_call at :179,
// body _make_apply_kernel :46).
//
// Bound: memory.  Per home slot it reads P inverse-route entries (4 B each),
// each live routed row (dm floats + its live byte) and the packed state row
// (dv floats), and writes dv floats plus the changed flag.
//
// Design: the TPU kernel accumulated chunks of route entries into a
// revisited VMEM block with one-hot matmuls and ran the vprog on the last
// chunk's visit.  Here apply_inv[q, v, pe] names the one route entry of
// source partition pe that carries home row v back, so the thread walks
// pe = 0..P-1 in ascending order — exactly the fixed-order f32 combine of
// ship_aggregates_home — and needs no atomics.  Default messages substitute
// in each leaf's own dtype, so an int32 identity such as 2^31-1 never
// passes through f32.  Every slot runs the vprog, messages or not.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

//@GENERATED@

extern "C" __global__ void apply_kernel(
    const float* __restrict__ pay, const unsigned char* __restrict__ live,
    const int* __restrict__ inv, const float* __restrict__ x,
    const int* __restrict__ vid, const unsigned char* __restrict__ vmask,
    int nl, int p, int k, int v_blk, float* __restrict__ newx,
    float* __restrict__ changed) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= (long long)nl * v_blk) return;
  const int q = (int)(s / v_blk);
  float acc[DM];
  for (int c = 0; c < DM; ++c) acc[c] = IDENT;
  int n = 0;
  const int* iv = inv + s * p;
  for (int pe = 0; pe < p; ++pe) {
    const int j = iv[pe];
    if (j < 0) continue;
    const long long r = ((long long)q * p + pe) * k + j;
    if (!live[r]) continue;
    ++n;
    for (int c = 0; c < DM; ++c) acc[c] = REDUCE(acc[c], pay[r * DM + c]);
  }
  const bool exists = n > 0;
  const float* xr = x + s * DV;
  const bool vm = vmask[s] != 0;
  float nw[DV];
  bool chg = false;
  //@APPLY@
  for (int c = 0; c < DV; ++c) newx[s * DV + c] = nw[c];
  changed[s] = chg ? 1.0f : 0.0f;
}

extern "C" int launch(const void* pay, const void* live, const void* inv,
                      const void* x, const void* vid, const void* vmask,
                      int nl, int p, int k, int v_blk, void* newx,
                      void* changed, void* stream) {
  const long long total = (long long)nl * v_blk;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    apply_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pay, (const unsigned char*)live, (const int*)inv,
        (const float*)x, (const int*)vid, (const unsigned char*)vmask, nl, p,
        k, v_blk, (float*)newx, (float*)changed);
  return (int)cudaGetLastError();
}
