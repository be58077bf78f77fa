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

#include "lstm_common.cuh"

namespace {

using lstm::kMaxSmem;
using lstm::kRows;
using lstm::kThreads;
using lstm::k_slices;
using lstm::sigmoid;
using lstm::WVec;

template <typename W>
__host__ __device__ inline size_t smem_floats(int H) {
  return (size_t)kRows * H * 3 + (size_t)kRows * 4 * H +
         (size_t)k_slices<W>(H, 4 * H) * kRows * 4 * H;
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
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int ks = k_slices<W>(H, H4);
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
    lstm::slice_products<W>(w, hq_s, part_s, H, H4);
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
