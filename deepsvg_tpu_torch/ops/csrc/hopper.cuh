// Hopper (sm_90a) primitives shared by the port's wgmma kernels, as inline
// PTX: shared-memory addresses, mbarriers, TMA tile loads and 1-D bulk
// copies with their completion on an mbarrier, the async-proxy fence,
// named barriers, stmatrix, setmaxnreg, wgmma matrix descriptors for the
// 128-byte swizzled layout that TMA writes, the wgmma fence / commit / wait,
// the wgmma shapes the kernels issue, and the warp-level mma.sync and
// ldmatrix that K2's attention runs. The host side encodes TMA tensor maps
// through the driver entry point the CUDA runtime hands out, so the library
// links against the runtime alone.
//
// Layout. Every wgmma operand in shared memory has the 128-byte swizzle:
// rows of 128 bytes, 8-row groups of 1,024 bytes, the 16-byte pieces of row r
// XORed with r % 8. A TMA box of {128 bytes, rows} with
// CU_TENSOR_MAP_SWIZZLE_128B lands in exactly that form at a 1,024-byte
// aligned address, and swizzle128() or stmatrix_x4 places values written by
// threads the same way. K-major, a row holds 64 bf16 (or 32 float) values of
// K: one wgmma step reads 32 bytes of K (16 bf16, or 8 float read as TF32),
// so a 128-byte slice is four steps, each advancing the descriptor's start
// address by 32 bytes. MN-major (bf16 only), a row is one value of K holding
// 64 values of M or N: a step reads 16 rows, advancing by 2,048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of byte `b` (< 128) of row `r` in a 128-byte swizzled region
__host__ __device__ __forceinline__ uint32_t swizzle128(uint32_t r, uint32_t b) {
  return r * 128u + ((((b >> 4) ^ (r & 7u)) << 4) | (b & 15u));
}

// the shared memory of a kernel, offsets from a 1,024-byte aligned base
struct Carve {
  uint32_t off = 0;
  __host__ __device__ uint32_t take(uint32_t bytes, uint32_t align = 1024) {
    off = (off + align - 1) / align * align;
    const uint32_t at = off;
    off += bytes;
    return at;
  }
};

// the dynamic shared memory, from its first 1,024-byte aligned byte (the
// alignment of the 128-byte swizzle's 8-row groups)
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. A wait of more
// than about ten seconds traps: a lost arrival fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// a ring position: the stage and the parity of its current use
struct PipeState {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ---- TMA and bulk copies, completing on an mbarrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// four 8x8 b16 matrices, each in the mma fragment layout (a lane holds
// row lane / 4, columns 2 (lane % 4) and + 1 of it in one register), to
// shared memory; lane l gives the address of row l % 8 of matrix l / 8. With
// TRANS each matrix is stored transposed: memory row k holds its column k.
template <bool TRANS>
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  if constexpr (TRANS)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                     addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                 "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- wgmma
// descriptor of a K-major, 128-byte swizzled operand at shared address
// `addr` (1,024-byte aligned at its 8-row groups, plus 32 bytes a K step):
// 8-row groups 1,024 bytes apart (SBO); LBO unused by this layout
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// issue or wait: the registers change asynchronously in between
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 operands in shared memory.
// K-major operands (TA = TB = 0) are A[64 x 16] and B^T[64 x 16], 128-byte
// rows of K. TA = 1 reads A MN-major: 16 rows of K, each 128 bytes of the
// 64 values of M; TB = 1 likewise B, rows of K holding the 64 values of N.
// In both layouts 8 rows of K (or of M, N) sit 1,024 bytes apart.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, bf16 operands K-major
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24), HOPPER_R8(32), HOPPER_R8(40),
        HOPPER_R8(48), HOPPER_R8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 96] (+)= A[64 x 16] B[96 x 16]^T, bf16 operands K-major
__device__ __forceinline__ void wgmma_m64n96k16_bf16(float (&d)[48], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24), HOPPER_R8(32), HOPPER_R8(40)
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- warp-level tensor-core products (mma.sync) and their fragment loads
// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 accumulators: a lane
// holds A's rows g and g + 8 (g = lane / 4) at columns 2 t4 (+1) and + 8
// (t4 = lane % 4), B's column g at rows 2 t4 (+1) and + 8, D's rows g and
// g + 8 at columns 2 t4 (+1)
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, lane l giving the address of row
// l % 8 of matrix l / 8 (16-byte aligned); lane l receives row l / 4, columns
// 2 (l % 4) and + 1 of each, or with TRANS of each matrix transposed
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// D[64 x 64] (+)= A[64 x 8] B[64 x 8]^T, float operands read as TF32
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 8] B[32 x 8]^T, float operands read as TF32
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] B[128 x 8]^T, float operands read as TF32
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24), HOPPER_R8(32), HOPPER_R8(40),
        HOPPER_R8(48), HOPPER_R8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 96] (+)= A[64 x 8] B[96 x 8]^T, float operands read as TF32
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[48], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24), HOPPER_R8(32), HOPPER_R8(40)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 8] B[16 x 8]^T, float operands read as TF32
__device__ __forceinline__ void wgmma_m64n16k8_tf32(float (&d)[8], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]^T, bf16 operands K-major
__device__ __forceinline__ void wgmma_m64n16k16_bf16(float (&d)[8], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_R8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[16 x 8] += A[16 x 8] B[8 x 8], float operands read as TF32 (m16n8k8): a
// lane holds A's rows g and g + 8 (g = lane / 4) at columns t4 and t4 + 4
// (t4 = lane % 4) as {(g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)},
// B's column g at rows t4 and t4 + 4, D as mma_m16n8k16_bf16's
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

#undef HOPPER_R8

// ---- host: the card's SM count (a persistent grid's size)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ---- host: a 2-D TMA tensor map over a row-major [outer, inner] tensor
// (`stride_bytes` between rows, a multiple of 16), boxes of
// {box_inner x box_outer} elements landing 128-byte swizzled; elements
// outside the tensor are read as zero
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// make the context of the device holding `ptr` current on this thread: the
// tensor-map encoder needs one, and a thread that has only queued work
// through PyTorch (autograd's backward thread) may have none yet
inline int bind_device_of(const void* ptr) {
  cudaPointerAttributes a;
  cudaError_t err = cudaPointerGetAttributes(&a, ptr);
  if (err == cudaSuccess) err = cudaSetDevice(a.device);
  return (int)err;
}

// 0 on success, else a CUDA error code to hand back to the caller
inline int make_tma_2d(CUtensorMap* map, const void* ptr, bool is_f32, uint64_t inner,
                       uint64_t outer, uint64_t stride_bytes, uint32_t box_inner,
                       uint32_t box_outer) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, is_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// make_tma_2d through a table of the maps encoded before: a map depends on
// its arguments alone, so one encoded for the same address, shape and box is
// copied instead of encoded again (the encoder's host time is what a call
// of small launches waits on, and a decode encodes its weights' maps once
// for its 240 steps). A miss binds the device of `ptr` first (see
// bind_device_of). The last TMA_MEMO maps are kept.
constexpr int TMA_MEMO = 64;

inline int make_tma_2d_cached(CUtensorMap* map, const void* ptr, bool is_f32, uint64_t inner,
                              uint64_t outer, uint64_t stride_bytes, uint32_t box_inner,
                              uint32_t box_outer) {
  struct Entry {
    const void* ptr;
    uint64_t inner, outer, stride;
    uint32_t box_inner, box_outer;
    bool is_f32;
    CUtensorMap map;
  };
  static Entry memo[TMA_MEMO];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = memo[i];
    if (e.ptr == ptr && e.inner == inner && e.outer == outer && e.stride == stride_bytes &&
        e.box_inner == box_inner && e.box_outer == box_outer && e.is_f32 == is_f32) {
      *map = e.map;
      return 0;
    }
  }
  int rc = bind_device_of(ptr);
  if (rc == 0) rc = make_tma_2d(map, ptr, is_f32, inner, outer, stride_bytes, box_inner, box_outer);
  if (rc) return rc;
  memo[next] = Entry{ptr, inner, outer, stride_bytes, box_inner, box_outer, is_f32, *map};
  next = (next + 1) % TMA_MEMO;
  used = used < TMA_MEMO ? used + 1 : TMA_MEMO;
  return 0;
}

}  // namespace hopper
