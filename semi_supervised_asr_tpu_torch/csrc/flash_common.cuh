// Helpers of the float32 route of the flash attention kernels
// (flash_mhsa_fwd.cu, flash_mhsa_bwd.cu), which runs on the CUDA cores; the
// bf16 route's are in flash_sm90.cuh.
//
// Layout: q, k, v, o and their gradients are [B, T, H, D] f32,
// contiguous, so row t of head h starts at
// ((b*T + t)*H + h)*D; the kernels read each head through that stride, with
// no transposes.  Per-row softmax statistics are [B, H, T] f32.
//
// Work split: a block owns one (batch row, head, tile of kBlock rows) and
// two threads own each row, each one half of the head dim, interleaved by
// 4-wide groups (thread half hf owns dims 8i + 4hf .. 8i + 4hf + 3), so the
// two threads of a pair read adjacent 16-byte words of a shared-memory row.
// A dot product over the head dim is each thread's half, in order, plus its
// partner's (one shuffle); both threads then hold the same value bit for
// bit, so both can run the softmax bookkeeping of the row.
//
// The head dim is a template bound DMAX in {32, 64, 128}: D <= DMAX, a
// multiple of 8, and the dims from D to DMAX are zeros in registers and in
// shared memory, so they add nothing.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBlock = 64;              // rows of a query tile or key tile
constexpr int kThreads = 2 * kBlock;    // two threads per row
constexpr float kMasked = -1e9f;        // the plain version's replaced score
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// this thread's half of row `row` (global, D valid dims) into registers;
// zeros when the row is outside the sequence
template <int DMAX>
__device__ __forceinline__ void load_half(const float* row, bool valid, int D,
                                          int hf, float4 (&x)[DMAX / 8]) {
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    const int d0 = 4 * (2 * i + hf);
    x[i] = (valid && d0 < D) ? load4(row + d0) : zero4();
  }
}

template <int DMAX>
__device__ __forceinline__ void store_half(float* row, int D, int hf,
                                           const float4 (&x)[DMAX / 8],
                                           float scale) {
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    const int d0 = 4 * (2 * i + hf);
    if (d0 < D)
      *reinterpret_cast<float4*>(row + d0) = make_float4(
          x[i].x * scale, x[i].y * scale, x[i].z * scale, x[i].w * scale);
  }
}

// kBlock rows of one head, starting at `first` (global), into shared memory
// as [kBlock][DMAX]; rows at or past `nrows` and dims past D are zeros
template <int DMAX>
__device__ __forceinline__ void load_tile(const float* first, size_t row_stride,
                                          int nrows, int D, float* dst) {
  constexpr int G = DMAX / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int idx = threadIdx.x; idx < kBlock * G; idx += blockDim.x) {
    const int r = idx / G;
    const int d0 = 4 * (idx - r * G);
    d4[idx] = (r < nrows && d0 < D)
                  ? load4(first + (size_t)r * row_stride + d0)
                  : zero4();
  }
}

// this thread's half of x . row (row: DMAX floats in shared memory), in order
template <int DMAX>
__device__ __forceinline__ float dot_half(const float4 (&x)[DMAX / 8],
                                          const float* row, int hf) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    const float4 y = r4[2 * i + hf];
    s = fmaf(x[i].x, y.x, s);
    s = fmaf(x[i].y, y.y, s);
    s = fmaf(x[i].z, y.z, s);
    s = fmaf(x[i].w, y.w, s);
  }
  return s;
}

// the full dot product: this thread's half plus its partner's
__device__ __forceinline__ float pair_sum(float part) {
  return part + __shfl_xor_sync(kFull, part, 1);
}

// acc += a * row (this thread's half of a shared-memory row)
template <int DMAX>
__device__ __forceinline__ void axpy_half(float4 (&acc)[DMAX / 8], float a,
                                          const float* row, int hf) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) {
    const float4 y = r4[2 * i + hf];
    acc[i].x = fmaf(a, y.x, acc[i].x);
    acc[i].y = fmaf(a, y.y, acc[i].y);
    acc[i].z = fmaf(a, y.z, acc[i].z);
    acc[i].w = fmaf(a, y.w, acc[i].w);
  }
}

// the head-dim bound for D (a multiple of 8 in [8, 128]), 0 if D is refused
inline int dmax_for(int D) {
  if (D < 8 || D > 128 || D % 8 != 0) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

}  // namespace flash
