// Masked LSTM forward scan for NVIDIA Hopper (sm_90a).
//
// Replaces: semi_supervised_asr_tpu/ops/pallas_lstm.py::_fwd_kernel (the
// Pallas TPU kernel reached through _fwd_call / lstm_scan_pallas, which
// runs every listener LSTM layer).  Launching D=2 directions at once also
// covers the forward half of _fwd_kernel_bidir.
//
// Per direction d and step t (t runs backward when bit d of reverse_mask
// is set), for every batch row:
//   gates = gates_x[d,t] + round(h) . round(w_hh[d])   (f32 products, f32 sum)
//   i,f,o = sigmoid, g = tanh of the four H-wide slices (order i,f,g,o)
//   c' = f*c + i*g;  h' = o*tanh(c')
//   h, c = v*h' + (1-v)*h, v*c' + (1-v)*c      (v = valid[t,row], 0 or 1)
//   h_out[d,t] = v*h'
// round() is to bfloat16 when w_hh arrives as bf16 (compute_dtype) and the
// identity for f32: a bf16 x bf16 product is exact in f32, so this is the
// TPU kernel's bf16 matmul with f32 accumulation.  Optional residuals
// (hprev, cprev = the carries before the step, acts = i,f,g,o) are written
// at the same time index as h_out, for the backward scan.
//
// What bounds it on this card: the serial h -> h dependency.  Each step
// needs the whole of w_hh (512 KB in bf16 at H=256) but only kRows*4H*H
// FMAs per block, so a step is a pass over L2 bounded by the latency of
// the loads and by one SM's L2 bandwidth, not by FLOPs.
//
// Design (simple and correct first): rows of an LSTM are independent, so
// one block owns (direction, tile of kRows batch rows) and loops over all
// T inside the kernel with h and c in shared memory -- no cross-block
// synchronisation and a single launch per layer.  w_hh is re-read from
// L2 every step (it does not fit in one SM's shared memory at H>=256);
// kRows rows share each weight load.  Phase 1a: each of 1024 threads owns
// a 16-byte column group (8 bf16 or 4 f32 columns) over one slice of k,
// so each thread issues only H/slices wide loads a step; 1b sums the
// slices in order; phase 2: each thread owns (row, unit) pairs and does
// the gate math.  A cluster / distributed-shared-memory split of w_hh
// over SMs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 4;
constexpr size_t kMaxSmem = 232448;   // per block, sm_90

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// 16-byte weight vectors: 4 float32 or 8 bfloat16 columns of one row k
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

// k-slices of the recurrent product per block: enough (column group,
// k-slice) work items to give every thread one, bounded by H.
template <typename W>
__host__ __device__ inline int k_slices(int H) {
  const int groups = 4 * H / WVec<W>::kN;
  int ks = kThreads / groups;
  if (ks < 1) ks = 1;
  if (ks > H) ks = H;
  return ks;
}

template <typename W>
__host__ __device__ inline size_t smem_floats(int H) {
  return (size_t)kRows * H * 3 + (size_t)kRows * 4 * H +
         (size_t)k_slices<W>(H) * kRows * 4 * H;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm_scan_fwd_kernel(const float* __restrict__ gates_x,   // [D,T,B,4H]
                     const W* __restrict__ w_hh,          // [D,H,4H]
                     const float* __restrict__ valid,     // [T,B]
                     float* __restrict__ h_out,           // [D,T,B,H]
                     float* __restrict__ hprev,           // [D,T,B,H] | NULL
                     float* __restrict__ cprev,           // [D,T,B,H] | NULL
                     float* __restrict__ acts,            // [D,T,B,4H] | NULL
                     int T, int B, int H, int reverse_mask) {
  constexpr int kVec = WVec<W>::kN;
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int groups = H4 / kVec;
  const int ks = k_slices<W>(H);
  const int slice = (H + ks - 1) / ks;
  float* h_s = smem;                 // [kRows, H] carry (f32)
  float* c_s = h_s + kRows * H;      // [kRows, H]
  float* hq_s = c_s + kRows * H;     // [kRows, H] h rounded to W
  float* g_s = hq_s + kRows * H;     // [kRows, 4H] pre-activations
  float* part_s = g_s + kRows * H4;  // [ks, kRows, 4H] k-slice partials

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B;
  const float* gx = gates_x + (size_t)d * seq * H4;
  const W* w = w_hh + (size_t)d * H * H4;
  float* ho = h_out + (size_t)d * seq * H;
  const bool residuals = hprev != nullptr;

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    h_s[i] = 0.f;
    c_s[i] = 0.f;
    hq_s[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const size_t base = (size_t)t * B + row0;   // first row of this tile

    // phase 1a: partial products over one k-slice for kVec columns
    for (int wi = threadIdx.x; wi < groups * ks; wi += blockDim.x) {
      const int grp = wi % groups;
      const int kk = wi / groups;
      const int k0 = kk * slice;
      const int k1 = min(H, k0 + slice);
      float acc[kRows][kVec];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;
      const W* wp = w + (size_t)k0 * H4 + grp * kVec;
#pragma unroll 2
      for (int k = k0; k < k1; ++k, wp += H4) {
        float wv[kVec];
        WVec<W>::load(wp, wv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = hq_s[r * H + k];
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            acc[r][v] = fmaf(hv, wv[v], acc[r][v]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float4* dst = reinterpret_cast<float4*>(
            part_s + ((size_t)kk * kRows + r) * H4 + grp * kVec);
#pragma unroll
        for (int v = 0; v < kVec; v += 4)
          dst[v / 4] = make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2],
                                   acc[r][v + 3]);
      }
    }
    __syncthreads();

    // phase 1b: sum the k-slices in order, add the input projection
    for (int idx = threadIdx.x; idx < nrows * H4; idx += blockDim.x) {
      const int r = idx / H4;
      const int j = idx - r * H4;
      float sum = 0.f;
      for (int kk = 0; kk < ks; ++kk)
        sum += part_s[((size_t)kk * kRows + r) * H4 + j];
      g_s[r * H4 + j] = gx[(base + r) * H4 + j] + sum;
    }
    __syncthreads();

    // phase 2: gate math, masked carry update, outputs
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H;
      const int u = idx - r * H;
      const float* g = g_s + r * H4;
      const float ig = sigmoid(g[u]);
      const float fg = sigmoid(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float og = sigmoid(g[3 * H + u]);
      const float h = h_s[r * H + u];
      const float c = c_s[r * H + u];
      const float c_new = fg * c + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float v = valid[base + r];
      const size_t o = (base + r) * H + u;
      if (residuals) {
        const size_t off = (size_t)d * seq * H + o;
        hprev[off] = h;
        cprev[off] = c;
        float* a = acts + ((size_t)d * seq + base + r) * H4;
        a[u] = ig;
        a[H + u] = fg;
        a[2 * H + u] = gg;
        a[3 * H + u] = og;
      }
      const float h2 = v * h_new + (1.f - v) * h;
      h_s[r * H + u] = h2;
      c_s[r * H + u] = v * c_new + (1.f - v) * c;
      hq_s[r * H + u] = WVec<W>::round(h2);
      ho[o] = v * h_new;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* gates_x, const void* w_hh, const float* valid,
           float* h_out, float* hprev, float* cprev, float* acts, int D,
           int T, int B, int H, int reverse_mask, cudaStream_t stream) {
  // 16-byte weight loads need whole vectors per row; shared memory caps H
  const size_t smem = smem_floats<W>(H) * sizeof(float);
  if ((4 * H) % WVec<W>::kN != 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kRows - 1) / kRows, D);
  lstm_scan_fwd_kernel<W><<<grid, kThreads, smem, stream>>>(
      gates_x, static_cast<const W*>(w_hh), valid, h_out, hprev, cprev,
      acts, T, B, H, reverse_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// gates_x [D,T,B,4H] f32, w_hh [D,H,4H] (bf16 when w_is_bf16 else f32),
// valid [T,B] f32 0/1, h_out [D,T,B,H] f32; hprev/cprev [D,T,B,H] and acts
// [D,T,B,4H] f32 all given or all NULL.  Contiguous, on the stream's device.
extern "C" int lstm_scan_fwd(const float* gates_x, const void* w_hh,
                             const float* valid, float* h_out, float* hprev,
                             float* cprev, float* acts, int D, int T, int B,
                             int H, int reverse_mask, int w_is_bf16,
                             void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_is_bf16)
    return launch<__nv_bfloat16>(gates_x, w_hh, valid, h_out, hprev, cprev,
                                 acts, D, T, B, H, reverse_mask, s);
  return launch<float>(gates_x, w_hh, valid, h_out, hprev, cprev, acts, D,
                       T, B, H, reverse_mask, s);
}
