// Masked multi-head self-attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces: jax's Pallas TPU flash attention forward
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel), which semi_supervised_asr_tpu/ops/flash_mhsa.py
// ::mhsa calls for the transformer and conformer listeners under
// model.attn_backend: flash.
//
// Computes, for every batch row b, head h and query row i (pad rows too):
//   s_ij = (q_i . k_j) * sm_scale                     f32 products, f32 sum
//   s_ij = key_mask[b, j] ? s_ij : -1e9               replaced, not added
//   o_i  = sum_j softmax(s_i)_j v_j                   f32 accumulators
// with p rounded to the compute dtype before the product with v (as the TPU
// kernel does), and saves the row max m and the row sum l of exp(s - m)
// ([B, H, T] f32) for the backward.  This is the plain version
// (ops/flash_mhsa.py::mhsa_reference) on every row: the TPU kernel's
// segment ids make a pad query attend pad keys instead, but the listeners
// zero pad rows, so valid rows are what the TPU computes, and matching the
// plain version everywhere lets the card compare whole tensors.  A row
// with no valid key gets -1e9 everywhere, hence uniform weights over all T
// keys: finite, as in the plain version (the masked score is a finite
// -1e9, never -inf).  Keys past T (the last tile's ragged tail) are left
// out of the softmax altogether.  m and l are kept apart, not as one
// logsumexp: at m = -1e9 a float32 m + log(l) loses log(l) entirely.
//
// What bounds it on this card: at the listener's shapes (T' <= 400, head
// dim 64) the products, 4*B*H*T^2*D flops; this first version runs them on
// the CUDA cores in f32 (no tensor cores, no TF32), so it sits far above
// the bf16 tensor-core bound.  Design (simple and correct first): one
// block per (b, h, 64 queries), two threads per query row (flash_common.cuh);
// K and V tiles of 64 keys are staged in shared memory as f32 and the block
// loops over them with an online softmax: the tile's 64 scores live in
// registers, the running max and sum in f32.  mma.sync / wgmma and TMA are
// later work.

#include "flash_common.cuh"

namespace {

using flash::kBlock;
using flash::kThreads;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ key_mask,   // [B, T]
                      T* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int Tn, int H, int D,
                      float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* v_s = k_s + kBlock * DMAX;               // [kBlock][DMAX]
  float* mk_s = v_s + kBlock * DMAX;              // 1 valid, 0 masked, -1 past T

  const int b = blockIdx.z, h = blockIdx.y;
  const int r = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int tq = blockIdx.x * kBlock + r;
  const size_t rs = (size_t)H * D;
  const size_t head0 = (size_t)b * Tn * rs + (size_t)h * D;

  float4 qr[kG], acc[kG];
  flash::load_half<T, DMAX>(q + head0 + (size_t)tq * rs, tq < Tn, D, hf, qr);
#pragma unroll
  for (int i = 0; i < kG; ++i) acc[i] = flash::zero4();
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += kBlock) {
    const int nk = min(kBlock, Tn - k0);
    __syncthreads();
    flash::load_tile<T, DMAX>(k + head0 + (size_t)k0 * rs, rs, nk, D, k_s);
    flash::load_tile<T, DMAX>(v + head0 + (size_t)k0 * rs, rs, nk, D, v_s);
    if (threadIdx.x < kBlock) {
      const int j = threadIdx.x;
      mk_s[j] = j < nk ? (key_mask[(size_t)b * Tn + k0 + j] ? 1.f : 0.f)
                       : -1.f;
    }
    __syncthreads();

    float s[kBlock];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      float sj = flash::pair_sum(flash::dot_half<DMAX>(qr, k_s + j * DMAX, hf))
                 * scale;
      const float mk = mk_s[j];
      sj = mk > 0.f ? sj : (mk == 0.f ? flash::kMasked : -INFINITY);
      s[j] = sj;
      mt = fmaxf(mt, sj);
    }
    // finite: key k0 is inside the sequence, so s[0] is a score or -1e9
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);   // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha;
      acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      const float p = expf(s[j] - m_new);   // 0 past T
      l += p;
      flash::axpy_half<DMAX>(acc, flash::Elem<T>::round(p), v_s + j * DMAX,
                             hf);
    }
    m = m_new;
  }

  if (tq < Tn) {
    flash::store_half<T, DMAX>(o + head0 + (size_t)tq * rs, D, hf, acc,
                               1.f / l);
    if (hf == 0) {
      const size_t row = ((size_t)b * H + h) * Tn + tq;
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v,
           const uint8_t* key_mask, void* o, float* m, float* l, int B,
           int Tn, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)kBlock * DMAX + kBlock) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mhsa_fwd_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + kBlock - 1) / kBlock, H, B);
  flash_mhsa_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_mask, static_cast<T*>(o), m, l, Tn, H, D,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dmax(const void* q, const void* k, const void* v,
                const uint8_t* key_mask, void* o, float* m, float* l, int B,
                int Tn, int H, int D, float scale, cudaStream_t stream) {
  switch (flash::dmax_for(D)) {
    case 32:
      return launch<T, 32>(q, k, v, key_mask, o, m, l, B, Tn, H, D, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, key_mask, o, m, l, B, Tn, H, D, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, key_mask, o, m, l, B, Tn, H, D, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o [B, T, H, D] (bf16 when is_bf16 else f32), key_mask [B, T]
// uint8 (1 valid), m, l [B, H, T] f32.  Contiguous, on the stream's device;
// D a multiple of 8 in [8, 128].
extern "C" int flash_mhsa_fwd(const void* q, const void* k, const void* v,
                              const uint8_t* key_mask, void* o, float* m,
                              float* l, int B, int T, int H, int D,
                              float sm_scale, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dmax<__nv_bfloat16>(q, k, v, key_mask, o, m, l, B, T, H, D,
                                      sm_scale, s);
  return launch_dmax<float>(q, k, v, key_mask, o, m, l, B, T, H, D, sm_scale,
                            s);
}
