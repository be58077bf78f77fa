// Hopper (sm_90a) building blocks of the bf16 flash attention kernels
// (flash_mhsa_fwd.cu, flash_mhsa_bwd.cu): mbarriers, TMA tile loads,
// warpgroup MMA (wgmma) on bf16 with f32 accumulators, and the host-side
// encoding of the tensor maps.
//
// Tiles.  q, k, v and dO are [B, T, H, D] bf16.  A rank-4 TMA tensor map
// with dims (D, H, T, B) and a box of (64, 1, 64, 1) copies 64 rows of one
// head and 64 head dims into shared memory as [64 rows][128 bytes] with the
// 128-byte swizzle (one "box", kBoxBytes).  Head dims past D and rows past
// T are zero-filled by the TMA unit, so a head dim below 64 costs nothing
// but the zeros' products; head dims 72-128 take two boxes (dims 0-63 and
// 64-127).  Every box starts on a 1024-byte boundary, as the swizzle needs.
//
// wgmma reads a box in two ways:
//   K-major (the reduction runs along the head dim, e.g. Q and K in
//   Q.K^T): 8-row groups 1024 bytes apart; a k-step of 16 dims advances
//   the start address by 32 bytes inside the 128-byte row.
//   MN-major (the reduction runs along the rows, e.g. V in P.V): the
//   transpose flag; 8-row groups along the reduction 1024 bytes apart, the
//   second box of 64 head dims one box further (the leading offset); a
//   k-step of 16 rows advances by 2048 bytes.
//
// Accumulator layout of an m64nN f32 wgmma (N/2 registers per thread of the
// 128-thread warpgroup): register i of thread t holds row 16*(t/32) +
// (t%32)/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(t%4) + i%2.  Two adjacent
// 8-column groups of a row-pair, rounded to bf16 and packed in pairs, are
// exactly the A fragment of a 16-deep k-step (wgmma with A in registers),
// so scores turned into weights never leave registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRows = 64;                  // rows of a tile (one wgmma M)
constexpr int kBoxBytes = kRows * 128;     // one box: 64 rows x 64 bf16
constexpr int kStages = 2;                 // ring depth of the streamed tiles
constexpr int kConsumers = 128;            // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // + one producer warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA: one box of a rank-4 map at (d0, h, t0, b) into shared memory,
// completion reported to `bar` as transaction bytes ----
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int d0, int h, int t0, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(t0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}
// a box read K-major: 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(1024) << 32 |
         1ull << 62;
}
// boxes read MN-major: 8-row groups 1024 bytes apart along the reduction,
// the next 64 columns one box further
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_field(addr) | desc_field(kBoxBytes) << 16 |
         desc_field(1024) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// between the asynchronous MMA's start and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory,
// both K-major (descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of the four 16-deep k-steps of a 64 x 64 accumulator
__device__ __forceinline__ void acc_to_a(const float (&s)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

// the largest of `v` over the four threads that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sync the consumer warpgroup only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// the first 1024-byte boundary at or after the dynamic shared memory
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// one past the last valid key of a batch row (0 if the row has none), from
// the whole block; `slot` is a shared int
__device__ __forceinline__ int key_end(const uint8_t* mask_row, int Tn,
                                       int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < Tn; j += blockDim.x)
    if (mask_row[j]) last = j + 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(slot, last);
  __syncthreads();
  return *slot;
}

// D[64 x 64] = A.B^T over the head dim: A and B are 64-row tiles of NB
// boxes (at shared addresses a and b), both read K-major
template <int NB>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_n64(d, desc_k(a + off), desc_k(b + off), kk > 0);
  }
}

// D[64 x 64 NB] += P.B over 64 rows: P the A fragments of a 64 x 64
// accumulator, B a 64-row tile of NB boxes at shared address b, read
// MN-major
template <int NB>
__device__ __forceinline__ void mma_cols(float (&d)[32 * NB],
                                         const uint32_t (&p)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (NB == 1)
      wgmma_rs_n64(d, p[j], desc_mn(b + j * 2048), 1);
    else
      wgmma_rs_n128(d, p[j], desc_mn(b + j * 2048), 1);
  }
}

// this thread's half-row rr of a 64 x 64 NB accumulator, times `scale`,
// into `row` (D bf16 values in global memory)
template <int NB>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&acc)[32 * NB],
                                          int rr, float scale, int D) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int c = 0; c < 8 * NB; ++c) {
    const int d = 8 * c + c0, i = 4 * c + 2 * rr;
    if (d < D)
      *reinterpret_cast<__nv_bfloat162*>(row + d) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The barriers of a block: one for the resident tiles, and a full and an
// empty barrier for each stage of the ring
struct Barriers {
  uint64_t resident, full[kStages], empty[kStages];
  __device__ void init() {
    mbar_init(&resident, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
};

// The producer thread.  Shared memory holds, from `smem`, the resident
// tiles (res_b may be null) and then the ring: kStages tiles of str_a, then
// kStages of str_b; a tile is 64 rows of NB boxes.  It loads the resident
// tiles at row t_res once, then rows 0, 64, ... of the streamed pair, one
// tile pair a stage, waiting for the consumers to release a stage before
// it refills it.
template <int NB>
__device__ __forceinline__ void produce(Barriers& bar,
                                       const CUtensorMap* res_a,
                                       const CUtensorMap* res_b, int t_res,
                                       const CUtensorMap* str_a,
                                       const CUtensorMap* str_b,
                                       uint8_t* smem, int n_tiles, int h,
                                       int b) {
  constexpr int kTile = NB * kBoxBytes;
  const int n_res = res_b ? 2 : 1;
  uint8_t* ring = smem + n_res * kTile;
  mbar_expect_tx(&bar.resident, n_res * kTile);
  for (int nb = 0; nb < NB; ++nb) {
    tma_load(smem + nb * kBoxBytes, res_a, 64 * nb, h, t_res, b,
             &bar.resident);
    if (res_b)
      tma_load(smem + kTile + nb * kBoxBytes, res_b, 64 * nb, h, t_res, b,
               &bar.resident);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    if (it >= kStages) mbar_wait(&bar.empty[st], (it / kStages - 1) & 1);
    mbar_expect_tx(&bar.full[st], 2 * kTile);
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(ring + st * kTile + nb * kBoxBytes, str_a, 64 * nb, h,
               it * kRows, b, &bar.full[st]);
      tma_load(ring + (kStages + st) * kTile + nb * kBoxBytes, str_b,
               64 * nb, h, it * kRows, b, &bar.full[st]);
    }
  }
}

// ---- host: tensor maps ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (so no -lcuda)
inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the map of a contiguous [B, T, H, D] bf16 tensor, boxes of 64 rows by 64
// head dims, 128-byte swizzle, zeros outside; 0 or a cudaError code
inline int encode_bthd(CUtensorMap* map, const void* base, int B, int T,
                       int H, int D) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t elt = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {elt * D, elt * D * H, elt * D * H * T};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
