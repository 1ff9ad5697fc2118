// Hopper building blocks shared by csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu (kernels/build.py:template inlines this
// header): the special-function exp2, cp.async, wgmma with its shared-
// memory descriptors and the 128-byte-swizzled tile layout, mbarriers and
// the TMA unit's tile loads, and the TMA descriptor of a [B, H, L, D] bf16
// tensor.  Nothing here depends on the head dimension.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

// 2^x on the special-function unit, subnormal results flushed to 0: the
// softmax's exp2(s - m) with s <= m (p of masked keys is set to 0 apart)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// Shared-memory layout of a 64-row tile of Q, K, V or dO (row = query row
// or key, D bf16 columns), the 128-byte swizzle of the wgmma descriptors:
// blocks of 64 columns, each 64 rows x 128 bytes, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8), so that the eight rows of a core
// matrix (and of an ldmatrix) fall in eight different bank groups.  The TMA
// unit writes a tile so (tensor_map's 128-byte swizzle).
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

// Descriptor of an MN-major operand (V for O += P V) at rows 16kk .. 16kk
// + 15, columns c0 ..: LBO the next 64 columns, SBO the next 8 rows.
__device__ __forceinline__ uint64_t desc_v(const unsigned char* t, int kk,
                                           int c0) {
  return gmma_desc(t + (c0 >> 6) * (64 * 128) + (c0 & 63) * 2 + kk * 2048,
                   64 * 128, 1024) | (1ull << 62);
}

// O[:, C : END] += P V[:, C : END] for 16-row step kk of the tile vt (V,
// or any MN-major B operand), o holding O's columns from CB; the columns
// are cut into N = 128, 64, 32, 16, each aligned to its width, so none
// crosses a 64-column block
template <int CB, int C, int END>
__device__ __forceinline__ void pv_cols(float* o, const uint32_t* a,
                                        const unsigned char* vt, int kk) {
  if constexpr (C < END) {
    constexpr int LEFT = END - C;
    constexpr int N = LEFT >= 128 && C % 128 == 0 ? 128
                      : LEFT >= 64 && C % 64 == 0 ? 64
                      : LEFT >= 32 && C % 32 == 0 ? 32 : 16;
    const uint64_t db = desc_v(vt, kk, C);
    if constexpr (N == 128) wgmma_rs_n128(o + (C - CB) / 2, a, db, 1);
    else if constexpr (N == 64) wgmma_rs_n64(o + (C - CB) / 2, a, db, 1);
    else if constexpr (N == 32) wgmma_rs_n32(o + (C - CB) / 2, a, db, 1);
    else wgmma_rs_n16(o + (C - CB) / 2, a, db, 1);
    pv_cols<CB, C + N, END>(o, a, vt, kk);
  }
}

// mbarriers and the TMA unit (cp.async.bulk.tensor) for a ring of tiles
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
// box (64 columns, 64 rows) of a [B, H, L, D] tensor at (c, row, h, b)
// into shared memory, 128-byte swizzled as tile_off lays it out; rows and
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

// TMA descriptor of a [B, H, L, D] bf16 tensor with element strides sl,
// sh, sb (unit stride on D): boxes of 64 columns x 64 rows, 128-byte
// swizzle; rows and columns past its ends arrive as zeros.
// cuTensorMapEncodeTiled comes through the runtime's entry-point query
// (the library links no -lcuda).  A dimension of size 1 gets a stride of
// 16 bytes: it is never stepped.
static int tensor_map(CUtensorMap* tm, const void* base, int d, int l, int h,
                      int b, long long sl, long long sh, long long sb) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return e != cudaSuccess ? (int)e : (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)l, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(l > 1 ? sl * 2 : 16),
                                 (cuuint64_t)(h > 1 ? sh * 2 : 16),
                                 (cuuint64_t)(b > 1 ? sb * 2 : 16)};
  const cuuint32_t box[4] = {64, 64, 1, 1}, step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}


// `bytes` (a multiple of 16) from global memory into shared memory by the
// TMA unit (both addresses 16-byte aligned), counted on `bar` as tma_load's
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
