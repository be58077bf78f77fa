// Masked LSTM backward scan for NVIDIA Hopper (sm_90a).
//
// Replaces: semi_supervised_asr_tpu/ops/pallas_lstm.py::_bwd_kernel (the
// Pallas TPU kernel that lstm_scan_pallas's custom VJP runs for every
// listener LSTM layer in training).  Launching D=2 directions at once also
// covers _bwd_kernel_bidir.
//
// Per direction d the step order is the reverse of the forward walk (t from
// T-1 down to 0 for a forward direction, upward when bit d of reverse_mask
// is set).  From the forward's residuals (acts = i,f,g,o and cprev, both
// at the time index of their step) and dh_out = dL/dh_out, per batch row:
//   c = f*cprev + i*g                       (recomputed)
//   dh_new = v*(dh + dh_out[t])
//   dc_new = dh_new*o*(1-tanh(c)^2) + v*dc
//   dgates[t] = [dc_new*g*i(1-i), dc_new*cprev*f(1-f), dc_new*i(1-g^2),
//                dh_new*tanh(c)*o(1-o)]
//   dh = (1-v)*dh + round(dgates) . round(w_hh)^T   (f32 products, f32 sum)
//   dc = (1-v)*dc + dc_new*f
// round() is to bfloat16 when the weights arrive as bf16 (compute dtype),
// as in the TPU kernel's bf16 matmul with f32 accumulation.  dW_hh =
// sum_t,b hprev^T dgates is one large product outside the kernel (as in
// JAX), so the kernel returns dgates only.
//
// What bounds it on this card: as for the forward scan, the serial
// dh -> dh dependency.  Each step needs all of w_hh (512 KB in bf16 at
// H=256) for kRows*4H*H FMAs per block, so a step is a pass over L2
// bounded by load latency and one SM's L2 bandwidth, not by FLOPs.
//
// Design (simple and correct first), mirroring the forward kernel: one
// block owns (direction, tile of kRows batch rows) and loops over all T
// with (dh, dc) in shared memory -- no cross-block synchronisation, one
// launch per layer.  The wrapper hands the weights transposed, [D,4H,H],
// so the product's reduction runs over rows of a contiguous matrix, exactly
// like the forward's h . w_hh: each thread owns a 16-byte group of output
// units over one slice of the 4H inputs (wide, coalesced loads; the
// dgates values are shared-memory broadcasts), and the slice partials are
// summed in a fixed order, so results do not change from run to run.
// A cluster / tensor-core split of w_hh over SMs is later work.

#include "lstm_common.cuh"

namespace {

using lstm::kMaxSmem;
using lstm::kRows;
using lstm::kThreads;
using lstm::k_slices;
using lstm::WVec;

template <typename W>
__host__ __device__ inline size_t smem_floats(int H) {
  return (size_t)kRows * H * 2 + (size_t)kRows * 4 * H +
         (size_t)k_slices<W>(4 * H, H) * kRows * H;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm_scan_bwd_kernel(const W* __restrict__ w_t,           // [D,4H,H]
                     const float* __restrict__ valid,     // [T,B]
                     const float* __restrict__ acts,      // [D,T,B,4H]
                     const float* __restrict__ cprev,     // [D,T,B,H]
                     const float* __restrict__ dh_out,    // [D,T,B,H]
                     float* __restrict__ dgates,          // [D,T,B,4H]
                     int T, int B, int H, int reverse_mask) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int ks = k_slices<W>(H4, H);
  float* dh_s = smem;                 // [kRows, H] dh carry
  float* dc_s = dh_s + kRows * H;     // [kRows, H] dc carry
  float* dg_s = dc_s + kRows * H;     // [kRows, 4H] dgates rounded to W
  float* part_s = dg_s + kRows * H4;  // [ks, kRows, H] slice partials

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B;
  const W* w = w_t + (size_t)d * H4 * H;
  const float* act = acts + (size_t)d * seq * H4;
  const float* cp = cprev + (size_t)d * seq * H;
  const float* dho = dh_out + (size_t)d * seq * H;
  float* dg = dgates + (size_t)d * seq * H4;

  // rows past nrows stay zero in dg_s, so the product ignores them
  for (int i = threadIdx.x; i < kRows * H4; i += blockDim.x) dg_s[i] = 0.f;
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    dh_s[i] = 0.f;
    dc_s[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const size_t base = (size_t)t * B + row0;   // first row of this tile

    // phase 1: gate gradients, dc carry, the (1-v) part of the dh carry
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H;
      const int u = idx - r * H;
      const float* a = act + (base + r) * H4;
      const float ig = a[u];
      const float fg = a[H + u];
      const float gg = a[2 * H + u];
      const float og = a[3 * H + u];
      const size_t o = (base + r) * H + u;
      const float c_prev = cp[o];
      const float v = valid[base + r];
      const float dh = dh_s[r * H + u];
      const float dc = dc_s[r * H + u];
      const float tc = tanhf(fg * c_prev + ig * gg);
      const float dh_new = v * (dh + dho[o]);
      const float dc_new = dh_new * og * (1.f - tc * tc) + v * dc;
      const float dgi = dc_new * gg * ig * (1.f - ig);
      const float dgf = dc_new * c_prev * fg * (1.f - fg);
      const float dgg = dc_new * ig * (1.f - gg * gg);
      const float dgo = dh_new * tc * og * (1.f - og);
      float* out = dg + (base + r) * H4;
      out[u] = dgi;
      out[H + u] = dgf;
      out[2 * H + u] = dgg;
      out[3 * H + u] = dgo;
      float* q = dg_s + r * H4;
      q[u] = WVec<W>::round(dgi);
      q[H + u] = WVec<W>::round(dgf);
      q[2 * H + u] = WVec<W>::round(dgg);
      q[3 * H + u] = WVec<W>::round(dgo);
      dh_s[r * H + u] = (1.f - v) * dh;
      dc_s[r * H + u] = (1.f - v) * dc + dc_new * fg;
    }
    __syncthreads();

    // phase 2: slice partials of dgates . w_hh^T
    lstm::slice_products<W>(w, dg_s, part_s, H4, H);
    __syncthreads();

    // phase 3: sum the slices in order into the dh carry
    for (int idx = threadIdx.x; idx < nrows * H; idx += blockDim.x) {
      const int r = idx / H;
      const int k = idx - r * H;
      float sum = 0.f;
      for (int kk = 0; kk < ks; ++kk)
        sum += part_s[((size_t)kk * kRows + r) * H + k];
      dh_s[r * H + k] += sum;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const void* w_t, const float* valid, const float* acts,
           const float* cprev, const float* dh_out, float* dgates, int D,
           int T, int B, int H, int reverse_mask, cudaStream_t stream) {
  // 16-byte weight loads need whole vectors of output units
  const size_t smem = smem_floats<W>(H) * sizeof(float);
  if (H % WVec<W>::kN != 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kRows - 1) / kRows, D);
  lstm_scan_bwd_kernel<W><<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(w_t), valid, acts, cprev, dh_out, dgates, T, B,
      H, reverse_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// w_t [D,4H,H] = w_hh transposed (bf16 when w_is_bf16 else f32), valid
// [T,B] f32 0/1, acts [D,T,B,4H], cprev and dh_out [D,T,B,H], dgates
// [D,T,B,4H], all f32.  Contiguous, on the stream's device.
extern "C" int lstm_scan_bwd(const void* w_t, const float* valid,
                             const float* acts, const float* cprev,
                             const float* dh_out, float* dgates, int D, int T,
                             int B, int H, int reverse_mask, int w_is_bf16,
                             void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_is_bf16)
    return launch<__nv_bfloat16>(w_t, valid, acts, cprev, dh_out, dgates, D,
                                 T, B, H, reverse_mask, s);
  return launch<float>(w_t, valid, acts, cprev, dh_out, dgates, D, T, B, H,
                       reverse_mask, s);
}
