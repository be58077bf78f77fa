// Helpers shared by the LSTM scan kernels (lstm_scan_fwd.cu, lstm_scan_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace lstm
