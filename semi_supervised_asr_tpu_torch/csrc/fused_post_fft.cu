// Fused post-FFT audio frontend for NVIDIA Hopper (sm_90a).
//
// Replaces: semi_supervised_asr_tpu/ops/pallas_frontend.py::_kernel (the
// Pallas TPU kernel reached through fused_post_fft).
//
// Computes, per utterance b and frame t (all float32):
//   mel[m] = sum_f pspec[b,t,f] * fb[f,m]          (Slaney mel bank)
//   y      = (log(max(mel, log_floor)) - mean[m]) * inv_std[m]
//   out    = 0 where t >= lens[b], or where m lies in one of the
//            utterance's SpecAugment frequency bands [fs, fs+fw), or t in
//            one of its time bands [ts, ts+tw); y elsewhere.
//
// What bounds it on this card: HBM.  The input is read once (257 floats a
// frame) and the output written once (80 floats a frame), ~1.3 KB a
// frame: 17 MB for a batch of 32 x 400 frames, ~5 us at 3.35 TB/s.  A
// dense [257 x 80] product per frame would instead make the kernel bound
// by shared-memory loads (measured ~2x slower than cuBLAS plus the
// elementwise tail on this card).
//
// Design: the mel bank is triangular -- filter m is non-zero only on a
// short run of FFT bins [lo_m, hi_m) -- so the caller passes each filter's
// run packed (band_w, band_lo, band_off) and the kernel sums only over it.
// Skipped terms are exact zeros: for finite inputs the in-order fp32 FMA
// sum over the run equals the dense in-order sum bit for bit (never TF32).
// A block stages a 32-frame tile of the spectrum and the packed bank in
// shared memory with coalesced loads; each thread then owns (frame, bin)
// outputs.  Any B and T are accepted (no lane padding as on the TPU).
// The band parameters are sampled by the caller, as the TPU kernel takes
// them through scalar prefetch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;           // frames per block
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // per block, sm_90

__global__ void __launch_bounds__(kThreads)
fused_post_fft_kernel(const float* __restrict__ pspec,
                      const float* __restrict__ band_w,
                      const int* __restrict__ band_lo,
                      const int* __restrict__ band_off,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv_std,
                      const int* __restrict__ lens,
                      const int* __restrict__ fs, const int* __restrict__ fw,
                      const int* __restrict__ ts, const int* __restrict__ tw,
                      int n_freq, int n_time,
                      float* __restrict__ out,
                      int T, int F, int M, float log_floor) {
  extern __shared__ float smem[];
  float* x_s = smem;                 // [kTile, F] spectrum tile
  float* w_s = smem + kTile * F;     // packed filter runs
  const int nnz = band_off[M];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);
  const float* src = pspec + ((size_t)b * T + t0) * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) x_s[i] = src[i];
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) w_s[i] = band_w[i];
  __syncthreads();

  const int len = lens[b];
  for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
    const int r = idx / M;
    const int m = idx - r * M;
    const float* xr = x_s + r * F + band_lo[m];
    const float* wm = w_s + band_off[m];
    const int n = band_off[m + 1] - band_off[m];
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(xr[k], wm[k], acc);
    const float y = (logf(fmaxf(acc, log_floor)) - mean[m]) * inv_std[m];

    const int t = t0 + r;
    bool keep = t < len;
    for (int i = 0; i < n_freq; ++i) {
      const int s = fs[b * n_freq + i];
      const int w = fw[b * n_freq + i];
      keep = keep && !(m >= s && m < s + w);
    }
    for (int i = 0; i < n_time; ++i) {
      const int s = ts[b * n_time + i];
      const int w = tw[b * n_time + i];
      keep = keep && !(t >= s && t < s + w);
    }
    out[((size_t)b * T + t) * M + m] = keep ? y : 0.f;
  }
}

}  // namespace

// pspec [B,T,F] f32; the mel bank [F,M] packed by filter: band_w [nnz]
// f32 holds fb[band_lo[m] + k, m] at band_off[m] + k, band_off [M+1] i32
// (band_off[M] = nnz), band_lo [M] i32; mean/inv_std [M] f32; lens [B]
// i32; fs/fw [B,n_freq], ts/tw [B,n_time] i32 (NULL when the count is 0);
// out [B,T,M] f32.  All contiguous, on the device of `stream`.
extern "C" int fused_post_fft(const float* pspec, const float* band_w,
                              const int* band_lo, const int* band_off,
                              int nnz,
                              const float* mean, const float* inv_std,
                              const int* lens,
                              const int* fs, const int* fw,
                              const int* ts, const int* tw,
                              int n_freq, int n_time,
                              float* out,
                              int B, int T, int F, int M, float log_floor,
                              void* stream) {
  if (B == 0 || T == 0) return 0;
  const size_t smem = ((size_t)kTile * F + nnz) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_post_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTile - 1) / kTile, B);
  fused_post_fft_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pspec, band_w, band_lo, band_off, mean, inv_std, lens, fs, fw, ts, tw,
      n_freq, n_time, out, T, F, M, log_floor);
  return (int)cudaGetLastError();
}
