// Masked multi-head self-attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces: jax's Pallas TPU flash attention backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_dkv_kernel and _flash_attention_dq_kernel), reached from
// semi_supervised_asr_tpu/ops/flash_mhsa.py::mhsa's custom VJP when the
// transformer or conformer listener trains under model.attn_backend: flash.
//
// With the forward's saved row max m and row sum l (flash_mhsa_fwd.cu), for
// every query row i and key j:
//   p_ij  = exp(s_ij - m_i) / l_i          s_ij recomputed as in the forward
//   delta_i = sum_d dO_id O_id             (O the forward's output)
//   dP_ij = dO_i . v_j
//   dS_ij = key_mask[j] ? p_ij (dP_ij - delta_i) sm_scale : 0
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i p_ij dO_i
// dS is zero at a masked key because the forward replaced that score with
// -1e9 (its gradient is cut), so a row with no valid key gets dq = 0 while
// its uniform weights still pass dO on to every v.  As in the TPU kernel,
// p and dS are rounded to the compute dtype before their products, and
// every sum is f32.  Keys and queries past T take no part.
//
// What bounds it: the products, about 2.5x the forward's (s and dP
// recomputed, then three accumulations), on the CUDA cores in f32.  Design:
// the TPU's two calls, so no atomics and a deterministic result; both run
// on the stream from one entry point, two launches:
//   1. dq: one block per (b, h, 64 queries), two threads per query row;
//      its prologue computes delta_i for the block's rows (and writes it for
//      launch 2), then it loops over K and V tiles in shared memory;
//   2. dk, dv: one block per (b, h, 64 keys), two threads per key row; it
//      loops over tiles of q, dO, m, 1/l and delta in shared memory.

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kThreads;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_mask,
                         const T* __restrict__ o, const T* __restrict__ dout,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         float* __restrict__ delta_out, T* __restrict__ dq,
                         int Tn, int H, int D, float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* v_s = k_s + kBlock * DMAX;               // [kBlock][DMAX]
  float* mk_s = v_s + kBlock * DMAX;              // 1 valid, 0 masked

  const int b = blockIdx.z, h = blockIdx.y;
  const int r = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int tq = blockIdx.x * kBlock + r;
  const bool in_seq = tq < Tn;
  const size_t rs = (size_t)H * D;
  const size_t head0 = (size_t)b * Tn * rs + (size_t)h * D;
  const size_t qrow = head0 + (size_t)tq * rs;
  const size_t stat = ((size_t)b * H + h) * Tn + tq;

  float4 qr[kG], dor[kG], acc[kG];
  flash::load_half<T, DMAX>(q + qrow, in_seq, D, hf, qr);
  flash::load_half<T, DMAX>(dout + qrow, in_seq, D, hf, dor);
  flash::load_half<T, DMAX>(o + qrow, in_seq, D, hf, acc);   // O, for delta
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    part = fmaf(dor[i].x, acc[i].x, part);
    part = fmaf(dor[i].y, acc[i].y, part);
    part = fmaf(dor[i].z, acc[i].z, part);
    part = fmaf(dor[i].w, acc[i].w, part);
    acc[i] = flash::zero4();
  }
  const float delta = flash::pair_sum(part);
  if (in_seq && hf == 0) delta_out[stat] = delta;
  // rows past T: p = 0 (q = 0 gives s = 0, times 1/l = 0)
  const float m = in_seq ? m_in[stat] : 0.f;
  const float inv_l = in_seq ? 1.f / l_in[stat] : 0.f;

  for (int k0 = 0; k0 < Tn; k0 += kBlock) {
    const int nk = min(kBlock, Tn - k0);
    __syncthreads();
    flash::load_tile<T, DMAX>(k + head0 + (size_t)k0 * rs, rs, nk, D, k_s);
    flash::load_tile<T, DMAX>(v + head0 + (size_t)k0 * rs, rs, nk, D, v_s);
    if (threadIdx.x < kBlock) {
      const int j = threadIdx.x;
      mk_s[j] = (j < nk && key_mask[(size_t)b * Tn + k0 + j]) ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {   // nk is the same for the whole block
      const float s = flash::pair_sum(
          flash::dot_half<DMAX>(qr, k_s + j * DMAX, hf)) * scale;
      const float dp = flash::pair_sum(
          flash::dot_half<DMAX>(dor, v_s + j * DMAX, hf));
      const bool valid = mk_s[j] > 0.f;
      const float p = expf((valid ? s : flash::kMasked) - m) * inv_l;
      const float ds = valid ? p * (dp - delta) * scale : 0.f;
      flash::axpy_half<DMAX>(acc, flash::Elem<T>::round(ds), k_s + j * DMAX,
                             hf);
    }
  }
  if (in_seq) flash::store_half<T, DMAX>(dq + qrow, D, hf, acc, 1.f);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ key_mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ delta_in,
                          T* __restrict__ dk, T* __restrict__ dv, int Tn,
                          int H, int D, float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* do_s = q_s + kBlock * DMAX;              // [kBlock][DMAX]
  float* m_s = do_s + kBlock * DMAX;              // [kBlock] row max
  float* il_s = m_s + kBlock;                     // [kBlock] 1 / row sum
  float* dl_s = il_s + kBlock;                    // [kBlock] delta

  const int b = blockIdx.z, h = blockIdx.y;
  const int c = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int tk = blockIdx.x * kBlock + c;
  const bool in_seq = tk < Tn;
  const bool valid = in_seq && key_mask[(size_t)b * Tn + tk];
  const size_t rs = (size_t)H * D;
  const size_t head0 = (size_t)b * Tn * rs + (size_t)h * D;
  const size_t krow = head0 + (size_t)tk * rs;
  const size_t stat0 = ((size_t)b * H + h) * Tn;

  float4 kr[kG], vr[kG], dka[kG], dva[kG];
  flash::load_half<T, DMAX>(k + krow, in_seq, D, hf, kr);
  flash::load_half<T, DMAX>(v + krow, in_seq, D, hf, vr);
#pragma unroll
  for (int i = 0; i < kG; ++i) dka[i] = dva[i] = flash::zero4();

  for (int q0 = 0; q0 < Tn; q0 += kBlock) {
    const int nq = min(kBlock, Tn - q0);
    __syncthreads();
    flash::load_tile<T, DMAX>(q + head0 + (size_t)q0 * rs, rs, nq, D, q_s);
    flash::load_tile<T, DMAX>(dout + head0 + (size_t)q0 * rs, rs, nq, D,
                              do_s);
    if (threadIdx.x < kBlock) {
      const int i = threadIdx.x;
      const bool in = i < nq;
      m_s[i] = in ? m_in[stat0 + q0 + i] : 0.f;
      il_s[i] = in ? 1.f / l_in[stat0 + q0 + i] : 0.f;
      dl_s[i] = in ? delta_in[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < nq; ++i) {   // nq is the same for the whole block
      const float s = flash::pair_sum(
          flash::dot_half<DMAX>(kr, q_s + i * DMAX, hf)) * scale;
      const float dp = flash::pair_sum(
          flash::dot_half<DMAX>(vr, do_s + i * DMAX, hf));
      const float p = expf((valid ? s : flash::kMasked) - m_s[i]) * il_s[i];
      flash::axpy_half<DMAX>(dva, flash::Elem<T>::round(p), do_s + i * DMAX,
                             hf);
      const float ds = valid ? p * (dp - dl_s[i]) * scale : 0.f;
      flash::axpy_half<DMAX>(dka, flash::Elem<T>::round(ds), q_s + i * DMAX,
                             hf);
    }
  }
  if (in_seq) {
    flash::store_half<T, DMAX>(dk + krow, D, hf, dka, 1.f);
    flash::store_half<T, DMAX>(dv + krow, D, hf, dva, 1.f);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v,
           const uint8_t* key_mask, const void* o, const void* dout,
           const float* m, const float* l, float* delta, void* dq, void* dk,
           void* dv, int B, int Tn, int H, int D, float scale,
           cudaStream_t stream) {
  const size_t tiles = 2 * (size_t)kBlock * DMAX;
  const size_t smem_dq = (tiles + kBlock) * sizeof(float);
  const size_t smem_dkv = (tiles + 3 * kBlock) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mhsa_bwd_dq_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_mhsa_bwd_dkv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dim3 grid((Tn + kBlock - 1) / kBlock, H, B);
  flash_mhsa_bwd_dq_kernel<T, DMAX><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, key_mask, static_cast<const T*>(o), dot, m, l, delta,
      static_cast<T*>(dq), Tn, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_mhsa_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, key_mask, dot, m, l, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Tn, H, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dmax(const void* q, const void* k, const void* v,
                const uint8_t* key_mask, const void* o, const void* dout,
                const float* m, const float* l, float* delta, void* dq,
                void* dk, void* dv, int B, int Tn, int H, int D, float scale,
                cudaStream_t s) {
  switch (flash::dmax_for(D)) {
    case 32:
      return launch<T, 32>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                           dv, B, Tn, H, D, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                           dv, B, Tn, H, D, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                            dv, B, Tn, H, D, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv [B, T, H, D] (bf16 when is_bf16 else f32),
// key_mask [B, T] uint8, m, l (from flash_mhsa_fwd) and delta (scratch) [B,
// H, T] f32.  Contiguous, on the stream's device; D a multiple of 8 in
// [8, 128].
extern "C" int flash_mhsa_bwd(const void* q, const void* k, const void* v,
                              const uint8_t* key_mask, const void* o,
                              const void* dout, const float* m,
                              const float* l, float* delta, void* dq,
                              void* dk, void* dv, int B, int T, int H, int D,
                              float sm_scale, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dmax<__nv_bfloat16>(q, k, v, key_mask, o, dout, m, l, delta,
                                      dq, dk, dv, B, T, H, D, sm_scale, s);
  return launch_dmax<float>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                            dv, B, T, H, D, sm_scale, s);
}
