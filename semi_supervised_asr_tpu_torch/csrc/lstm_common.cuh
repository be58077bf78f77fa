// Helpers shared by the LSTM scan kernels (lstm_scan_fwd.cu, lstm_scan_bwd.cu):
// the CUDA-core route (float32, and bfloat16 where no cluster plan fits) and
// the cluster route (bfloat16 on sm_90a: thread-block clusters, distributed
// shared memory, mma.sync on the tensor cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lstm {

constexpr int kThreads = 1024;
constexpr int kRows = 4;              // batch rows per block
constexpr size_t kMaxSmem = 232448;   // per block, sm_90

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// 16-byte weight vectors: 4 float32 or 8 bfloat16 columns of one row
template <typename W>
struct WVec;
template <>
struct WVec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};
template <>
struct WVec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// Row slices of a [K, N] weight product per block: enough (16-byte column
// group of N, slice of K) work items to give every thread one, at most K.
template <typename W>
__host__ __device__ inline int k_slices(int K, int N) {
  const int groups = N / WVec<W>::kN;
  int ks = kThreads / groups;
  if (ks < 1) ks = 1;
  if (ks > K) ks = K;
  return ks;
}

// part[ks, kRows, N] += rows of in_s[kRows, K] . w[K, N], one (column
// group, K slice) work item per thread; the caller sums the slices.
template <typename W>
__device__ __forceinline__ void slice_products(const W* __restrict__ w,
                                               const float* in_s,
                                               float* part_s, int K, int N) {
  constexpr int kVec = WVec<W>::kN;
  const int groups = N / kVec;
  const int ks = k_slices<W>(K, N);
  const int slice = (K + ks - 1) / ks;
  for (int wi = threadIdx.x; wi < groups * ks; wi += blockDim.x) {
    const int grp = wi % groups;
    const int kk = wi / groups;
    const int k0 = kk * slice;
    const int k1 = min(K, k0 + slice);
    float acc[kRows][kVec];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;
    const W* wp = w + (size_t)k0 * N + grp * kVec;
#pragma unroll 2
    for (int k = k0; k < k1; ++k, wp += N) {
      float wv[kVec];
      WVec<W>::load(wp, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = in_s[r * K + k];
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float4* dst = reinterpret_cast<float4*>(
          part_s + ((size_t)kk * kRows + r) * N + grp * kVec);
#pragma unroll
      for (int v = 0; v < kVec; v += 4)
        dst[v / 4] = make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2],
                                 acc[r][v + 3]);
    }
  }
}

// ---- the cluster route ----
//
// A cluster of C blocks owns one (direction, tile of R batch rows); block j
// owns the hidden units [j*u, (j+1)*u), u = H/C.  Each step's product is
// D[M, R] = A[M, K] . B[K, R] on mma.sync m16n8k16 (bf16 in, f32 sums): A
// is the block's slice of the weights, resident in shared memory for the
// whole scan in the order of the A fragments (the wrapper lays it out, see
// ops/lstm_scan.py), so one lane loads its fragment of a 16 x 16 tile as
// one 16-byte word; B is the exchanged vector (h, or dgates) of the R rows
// in bf16, as C slabs, one from each block: slab j is [R][W + 8] with
// block j's W values of each row (its u units of h, or its 4 gate groups
// of u dgates), so the K order is block by block (the weights' fragment
// order follows it) and a block's contribution is contiguous (the
// backward sends it as one bulk copy).  The 8-element pad puts the 8 rows
// of a fragment load on distinct banks.

constexpr int kClusterThreads = 256;   // launch bound of the cluster kernels
constexpr int kPad = 8;                // bf16 pad of a B row
constexpr int kChunk = 32768;          // bytes per bulk copy of the weights

// Shared memory of one block (bytes): kHeader for three mbarriers (the
// resident weights', and the exchange buffers' of each step parity), the
// weight slice, the exchanged rows by step parity (one slab of R rows of
// W + kPad bf16 from each of the C blocks, W = u for h, 4u for dgates),
// and the block's own slab by step parity.
constexpr int kHeader = 32;
__host__ __device__ inline size_t slabs_smem(int C, int R, int W) {
  return 2 * (size_t)(C + 1) * R * (W + kPad) * 2;
}
__host__ __device__ inline size_t fwd_cluster_smem(int H, int C, int R) {
  const size_t u = H / C;
  return kHeader + (size_t)H * 4 * u * 2 + slabs_smem(C, R, (int)u);
}
__host__ __device__ inline size_t bwd_cluster_smem(int H, int C, int R) {
  const size_t u = H / C;
  return kHeader + u * 4 * (size_t)H * 2 + slabs_smem(C, R, 4 * (int)u);
}

// Threads of a block of a valid plan (C blocks a cluster, R rows a tile),
// or 0 for a plan the route cannot take: u = H/C a multiple of 16 (a
// k-step never straddles two blocks' slabs; the backward's unit tiles).
// Forward: a warp per (8 units, 8 rows); backward: a warp per (16 units,
// 8 rows).
inline bool plan_ok(int H, int C, int R, size_t smem) {
  return C >= 1 && C <= 16 && H % C == 0 && (H / C) % 16 == 0 && R >= 8 &&
         R % 8 == 0 && smem <= kMaxSmem;
}
inline int fwd_cluster_threads(int H, int C, int R) {
  if (!plan_ok(H, C, R, C >= 1 ? fwd_cluster_smem(H, C, R) : 0)) return 0;
  const int threads = 32 * (H / C / 8) * (R / 8);
  return threads <= kClusterThreads ? threads : 0;
}
inline int bwd_cluster_threads(int H, int C, int R) {
  if (!plan_ok(H, C, R, C >= 1 ? bwd_cluster_smem(H, C, R) : 0)) return 0;
  const int threads = 32 * (H / C / 16) * (R / 8);
  return threads <= kClusterThreads ? threads : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// One cluster barrier (the .aligned forms want the warp converged).  The
// scans use it only to start (every block's mbarriers are set before the
// first remote store) and to finish (no block leaves while a peer may
// still store into it).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- mbarriers ----
// thread 0 sets n barriers to one arrival each; every thread calls it
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}
// the one arrival of the barrier's current phase, which then completes
// once `bytes` have arrived (one thread)
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase of this parity; what the
// phase counted (stores from other blocks too) is then visible.  A phase
// that never completes is a fault of the exchange: after ~4e9 cycles (~2 s)
// the kernel traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}
// A warp's part of this block's slab into every block of the cluster:
// its 8 rows of 16 bytes, `src` here to `dst` there (row stride `ld`
// bf16), each by st.async counted on that block's barrier `bar` when it
// lands.  (The slab's other rows and columns are other warps'.)
__device__ __forceinline__ void send_rows(const __nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          uint64_t* bar, int C) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const uint32_t d0 = smem_u32(dst), b0 = smem_u32(bar);
  for (int i = lane; i < 8 * C; i += 32) {
    const int r = i & 7, p = i >> 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * ld);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(
            map_rank(d0 + (uint32_t)(r * ld) * 2, p)),
        "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(map_rank(b0, p))
        : "memory");
  }
}

// Send this block's slab (all warps wrote it) into every block of the
// cluster: `bytes` at `src` here to offset `dst` there, by the bulk-copy
// engine, counted on that block's barrier at offset `bar`.  Every thread
// calls it; lane p of warp 0 issues the copy to block p.
__device__ __forceinline__ void send_slab(uint32_t dst, uint32_t src,
                                          uint32_t bytes, uint32_t bar,
                                          int C) {
  // the generic-proxy stores to the slab before the bulk copy reads it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x < C)
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n" ::"r"(map_rank(dst, threadIdx.x)),
        "r"(src), "r"(bytes), "r"(map_rank(bar, threadIdx.x))
        : "memory");
}

// d += a . b for one m16n8k16 tile: a is the lane's A fragment (4 words),
// b0/b1 its two B words
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
// the lane's B fragment of a k16 x n8 tile whose column n is row n of a
// row-major [*, ld] bf16 array: rows lane/4, elements 2*(lane%4) and +8
__device__ __forceinline__ void b_frag(const __nv_bfloat16* rows, int ld,
                                       int k0, uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = rows + (lane >> 2) * ld + k0 + 2 * (lane & 3);
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}
__device__ __forceinline__ __nv_bfloat16 bf16(float x) {
  return __float2bfloat16_rn(x);
}

// Copy `bytes` (a multiple of 16) of weights into shared memory once, by
// the bulk-copy engine, counted on the (set) barrier `bar`, and wait for
// them: every thread calls it.
__device__ __forceinline__ void load_resident(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  if (threadIdx.x == 0) {
    expect_bytes(bar, bytes);
    for (uint32_t off = 0; off < bytes; off += kChunk) {
      const uint32_t n = min((uint32_t)kChunk, bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst) + off),
          "l"(static_cast<const char*>(src) + off), "r"(n),
          "r"(smem_u32(bar))
          : "memory");
    }
  }
  wait_phase(bar, 0);
}

// Launch `kernel` as clusters of C blocks along x (grid.x a multiple of C).
template <typename... KArgs, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(KArgs...), dim3 grid,
                                   int threads, size_t smem, int C,
                                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of this shape the card holds at once (0 if none fits).
template <typename... KArgs>
inline cudaError_t max_clusters(void (*kernel)(KArgs...), int threads,
                                size_t smem, int C, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

}  // namespace lstm
