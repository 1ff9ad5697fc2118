// Fused Pregel apply: combine the routed aggregates of each home vertex,
// substitute the default message, run the vprog, keep invisible rows and
// derive the changed bit, in one pass over the home slots.
//
// Replaces: src/repro/kernels/superstep.py:fused_apply (pallas_call at :179,
// body _make_apply_kernel :46).
//
// Bound: memory.  The function reads each live route entry (4 B) and its
// flag byte, each live routed row (dm values), the apply_rng words of its
// CTAs, the state columns the vprog or the changed test reads and the mask
// byte, and writes the columns the vprog computes plus one changed byte a
// slot.
//
// Design: the TPU kernel grouped the route's entries into chunks by home
// block and closed each block's combine in VMEM on its last visit.  Here a
// CTA owns VB consecutive home slots [v0, v0 + VB) of partition q.  The
// route is sorted by home slot within each (q, pe) row (applyroute.cuh), so
// the CTA's entries of source partition pe are one contiguous span, whose
// ends it reads from apply_rng at its granule boundaries (all P spans in
// one round, into shared memory).  For pe = 0 .. P-1 in order, the CTA's
// threads stride over that span (LANES threads a row), each loading EPT
// entries' flag, slot and message columns in one round, and reduce each
// live row into its slot's accumulator in shared memory.  Within one pe no
// two entries share a slot, and a __syncthreads() separates the source
// partitions, so every slot combines in ascending pe without atomics: the
// fixed f32 order of ship_aggregates_home and of kernels/ref.py:fused_apply,
// bit for bit.  Then each thread takes VB / THREADS slots of the block,
// loads the state they read in one round, and runs the generated apply body
// on each: defaults substitute in each message leaf's own dtype, leaves
// are read and written where they lie in their own dtypes (staged through
// f32 as the packed path did), invisible rows copy their old bits, and a
// leaf the vprog passes through is neither read (unless the changed test
// needs it) nor written.  A CTA makes few dependent rounds of loads and a
// thread keeps several loads in flight: with one slot and one dependent
// load at a time, the gathers' latency, not the bytes, sets the time.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include "applyroute.cuh"

//@GENERATED@

static_assert(VB % APPLY_GRAN == 0, "a CTA owns whole granules");
static_assert(VB % THREADS == 0, "each thread applies VB / THREADS slots");

struct ApplyArgs {
  const int* send;              // [nl, P, K] home slot of each route entry
  const unsigned char* rflags;  // [nl, P, K] the entry carries a value
  const int* rng;               // [nl, P, n_rng] apply_rng
  const int* vid;               // [nl, V_blk]
  const unsigned char* vmask;   // [nl, V_blk]
  unsigned char* changed;       // [nl, V_blk]
  const void* m[NMSG];          // routed message leaves [nl, P, K, w]
  const void* x[NSTATE];        // vertex leaves [nl, V_blk, w]
  void* o[NSTATE];              // written leaves (null: passed through)
  int p, k, v_blk, n_rng;
};

// column c of routed row r, as f32
__device__ __forceinline__ float msg_col(const ApplyArgs& a, long long r,
                                         int c) {
  //@MSGCOL@
}

extern "C" __global__ void __launch_bounds__(THREADS)
apply_kernel(const ApplyArgs a) {
  extern __shared__ float accsh[];                        // [VB][STRIDE]
  unsigned char* hit = (unsigned char*)(accsh + VB * STRIDE);   // [VB]
  int* span = (int*)(hit + ((VB + 3) & ~3));              // [P][2]
  const int q = blockIdx.y;
  const int v0 = blockIdx.x * VB;
  const int nv = min(VB, a.v_blk - v0);
  const int b0 = v0 / APPLY_GRAN;
  const int b1 = min(b0 + VB / APPLY_GRAN, a.n_rng - 1);
  for (int i = threadIdx.x; i < VB * STRIDE; i += THREADS) accsh[i] = IDENT;
  for (int i = threadIdx.x; i < VB; i += THREADS) hit[i] = 0;
  // every source partition's span of the route, read in one round
  for (int i = threadIdx.x; i < 2 * a.p; i += THREADS)
    span[i] = a.rng[((long long)q * a.p + i / 2) * a.n_rng + (i % 2 ? b1 : b0)];
  __syncthreads();

  // combine: EPT entries a thread in flight, their flag, slot and message
  // columns loaded in one round (j lies in the route's live prefix, so
  // every address is valid), then reduced into shared memory
  constexpr int CPL = (DM + LANES - 1) / LANES;   // columns a lane
  constexpr int STEP = THREADS / LANES;           // entries a pass
  const int col = threadIdx.x % LANES;
  for (int pe = 0; pe < a.p; ++pe) {
    const long long row = (long long)q * a.p + pe;
    const int j1 = span[2 * pe + 1];
    for (int j = span[2 * pe] + threadIdx.x / LANES; j < j1; j += EPT * STEP) {
      bool live[EPT];
      int v[EPT];
      float m[EPT][CPL];
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const long long r = row * a.k + j + u * STEP;
        live[u] = j + u * STEP < j1 && a.rflags[r] != 0;
        v[u] = j + u * STEP < j1 ? a.send[r] - v0 : -1;
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          m[u][i] = j + u * STEP < j1 && col + i * LANES < DM
                        ? msg_col(a, r, col + i * LANES) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        if (!live[u] || v[u] < 0 || v[u] >= nv) continue;   // v: corrupt table
        if (col == 0) hit[v[u]] = 1;
        float* acc = accsh + v[u] * STRIDE;
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          if (col + i * LANES < DM)
            acc[col + i * LANES] = REDUCE(acc[col + i * LANES], m[u][i]);
      }
    }
    __syncthreads();          // the next source partition combines after
  }

  // apply: slot i = threadIdx.x + u * THREADS, u < VB / THREADS; the state
  // each slot reads is loaded for all of a thread's slots first
  constexpr int SPT = VB / THREADS;
  //@LOADS@
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i >= nv) break;
    const long long s = (long long)q * a.v_blk + v0 + i;
    const bool exists = hit[i] != 0;
    const float* acc = accsh + i * STRIDE;
    //@APPLY@
  }
}

extern "C" int launch(void* const* ptrs, int nl, int p, int k, int v_blk,
                      int n_rng, void* stream) {
  ApplyArgs a;
  a.send = (const int*)ptrs[0];
  a.rflags = (const unsigned char*)ptrs[1];
  a.rng = (const int*)ptrs[2];
  a.vid = (const int*)ptrs[3];
  a.vmask = (const unsigned char*)ptrs[4];
  a.changed = (unsigned char*)ptrs[5];
  for (int l = 0; l < NMSG; ++l) a.m[l] = ptrs[6 + l];
  for (int l = 0; l < NSTATE; ++l) {
    a.x[l] = ptrs[6 + NMSG + l];
    a.o[l] = ptrs[6 + NMSG + NSTATE + l];
  }
  a.p = p;
  a.k = k;
  a.v_blk = v_blk;
  a.n_rng = n_rng;
  const int smem = SMEM + 8 * p;       // and the span table
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((v_blk + VB - 1) / VB, nl);
  if (grid.x > 0 && nl > 0)
    apply_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
