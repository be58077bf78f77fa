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
// The key loop stops at each batch row's last valid key (kv_end, which
// every block reduces from the row's key_mask in its prologue; all T keys
// for a row with none).  Past it every score is -1e9, whose weight
// exp(-1e9 - m) is exactly 0 in f32 once the row has a valid key: m is
// unchanged and l only loses added zeros, so the cut is exact for any
// mask, prefix or not.
//
// What bounds it on this card: at the listener's shapes (T' <= 400, head
// dim 64) the bytes (q, k, v read, o written: ~53 MB at B=32, T=400, 8
// heads, 16 us at 3.35 TB/s), ahead of the bf16 products (4*H*D*T per valid
// key, ~7 us at 989 TFLOP/s).  Two routes behind one entry point:
//
// bf16 (every shipped recipe): the products on the tensor cores.  One
// block per (b, h, 64 queries): one consumer warpgroup and one producer
// warp.  The producer's single thread loads Q once and streams K and V
// tiles of 64 keys through a 2-stage ring in shared memory by TMA
// (flash_sm90.cuh), each stage's arrival reported to an mbarrier and its
// release by the consumers to another, so loads overlap the products.  The
// consumers run S = Q.K^T as wgmma from shared memory, the masking and the
// online softmax on the accumulator registers, then O += P.V with P
// rounded to bf16 in registers as wgmma's A operand and V read MN-major:
// nothing is transposed, nothing but the tiles touches shared memory.
//
// f32 (exactness checks against the plain version at 1e-5; TF32 tensor
// cores would not hold that): the CUDA cores, one block per (b, h, 64
// queries), two threads per query row (flash_common.cuh), K and V tiles
// converted into shared memory, the same kv_end cut.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using flash::kBlock;
using flash::kThreads;

// ---- float32: CUDA cores ----

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_fwd_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ key_mask,   // [B, T]
                      float* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int Tn, int H, int D,
                      float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* v_s = k_s + kBlock * DMAX;               // [kBlock][DMAX]
  float* mk_s = v_s + kBlock * DMAX;   // 1 valid, 0 masked, -1 past T

  __shared__ int end_s;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int tq = blockIdx.x * kBlock + r;
  const size_t rs = (size_t)H * D;
  const size_t head0 = (size_t)b * Tn * rs + (size_t)h * D;

  float4 qr[kG], acc[kG];
  flash::load_half<DMAX>(q + head0 + (size_t)tq * rs, tq < Tn, D, hf, qr);
#pragma unroll
  for (int i = 0; i < kG; ++i) acc[i] = flash::zero4();
  float m = -INFINITY, l = 0.f;
  const int kv_end = sm90::key_end(key_mask + (size_t)b * Tn, Tn, &end_s);
  const int k_stop = kv_end > 0 ? kv_end : Tn;

  for (int k0 = 0; k0 < k_stop; k0 += kBlock) {
    const int nk = min(kBlock, Tn - k0);
    __syncthreads();
    flash::load_tile<DMAX>(k + head0 + (size_t)k0 * rs, rs, nk, D, k_s);
    flash::load_tile<DMAX>(v + head0 + (size_t)k0 * rs, rs, nk, D, v_s);
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
      flash::axpy_half<DMAX>(acc, p, v_s + j * DMAX,
                             hf);
    }
    m = m_new;
  }

  if (tq < Tn) {
    flash::store_half<DMAX>(o + head0 + (size_t)tq * rs, D, hf, acc,
                               1.f / l);
    if (hf == 0) {
      const size_t row = ((size_t)b * H + h) * Tn + tq;
      m_out[row] = m;
      l_out[row] = l;
    }
  }
}

// ---- bfloat16: tensor cores, TMA ----

// NB boxes of 64 head dims (1: D <= 64, 2: D <= 128)
template <int NB>
__global__ void __launch_bounds__(sm90::kThreads, NB == 1 ? 3 : 2)
flash_mhsa_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const uint8_t* __restrict__ key_mask,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int Tn, int H, int D,
                           float scale) {
  using namespace sm90;
  constexpr int kTile = NB * kBoxBytes;   // one tile: 64 rows, all boxes
  __shared__ Barriers bar;
  __shared__ int end_s;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);     // Q, then the K and V rings
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const uint8_t* mask_row = key_mask + (size_t)b * Tn;
  if (tid == 0) bar.init();
  const int kv_end = key_end(mask_row, Tn, &end_s);   // syncs the block
  const int n_tiles = ((kv_end > 0 ? kv_end : Tn) + kRows - 1) / kRows;

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      produce<NB>(bar, &tm_q, nullptr, qt * kRows, &tm_k, &tm_v, q_s,
                  n_tiles, h, b);
    return;
  }

  // consumers: this thread's rows r0 and r0 + 8 of the tile
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  const uint32_t q_a = smem_u32(q_s), k_a = q_a + kTile,
                 v_a = k_a + kStages * kTile;
  float acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(&bar.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&bar.full[st], (it / kStages) & 1);
    float s[32];
    wgmma_fence();
    mma_rows<NB>(s, q_a, k_a + st * kTile);   // S = Q.K^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask: valid -> scaled score, masked -> -1e9, past T -> -inf
    const int k0 = it * kRows;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * c + c0 + e;
        const int kind = key < Tn ? (mask_row[key] ? 1 : 0) : -1;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& x = s[4 * c + 2 * rr + e];
          x = kind > 0 ? x * scale : (kind == 0 ? flash::kMasked : -INFINITY);
          mt[rr] = fmaxf(mt[rr], x);
        }
      }
    // online softmax; finite: key k0 lies inside the sequence
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mt[rr]));
      alpha[rr] = __expf(m[rr] - m_new);   // 0 on the first tile
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __expf(s[i] - m[(i >> 1) & 1]);   // 0 past T
      l[(i >> 1) & 1] += s[i];                 // this thread's columns
    }
    uint32_t p[4][4];
    acc_to_a(s, p);

    fence_regs(acc);
    fence_regs(p);
    wgmma_fence();
    mma_cols<NB>(acc, p, v_a + st * kTile);   // O += P.V
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&bar.empty[st]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qt * kRows + r0 + 8 * rr;
    const float lr = quad_sum(l[rr]);
    if (row >= Tn) continue;
    store_row<NB>(o + (((size_t)b * Tn + row) * H + h) * D, acc, rr,
                  1.f / lr, D);
    if ((tid & 3) == 0) {
      const size_t at = ((size_t)b * H + h) * Tn + row;
      m_out[at] = m[rr];
      l_out[at] = lr;
    }
  }
}

template <int NB>
int launch_bf16(const void* q, const void* k, const void* v,
                const uint8_t* key_mask, void* o, float* m, float* l, int B,
                int Tn, int H, int D, float scale, cudaStream_t stream) {
  // Q, the K and V rings, and room to align them to 1024 bytes
  constexpr int smem = (1 + 2 * sm90::kStages) * NB * sm90::kBoxBytes + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mhsa_fwd_bf16_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_bthd(&tq, q, B, Tn, H, D);
  if (!err) err = sm90::encode_bthd(&tk, k, B, Tn, H, D);
  if (!err) err = sm90::encode_bthd(&tv, v, B, Tn, H, D);
  if (err) return err;
  dim3 grid((Tn + sm90::kRows - 1) / sm90::kRows, H, B);
  flash_mhsa_fwd_bf16_kernel<NB><<<grid, sm90::kThreads, smem, stream>>>(
      tq, tk, tv, key_mask, static_cast<__nv_bfloat16*>(o), m, l, Tn, H, D,
      scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v,
               const uint8_t* key_mask, void* o, float* m, float* l, int B,
               int Tn, int H, int D, float scale, cudaStream_t stream) {
  constexpr int smem = (2 * kBlock * DMAX + kBlock) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mhsa_fwd_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Tn + kBlock - 1) / kBlock, H, B);
  flash_mhsa_fwd_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), key_mask, static_cast<float*>(o), m, l,
      Tn, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o [B, T, H, D] (bf16 when is_bf16 else f32), key_mask [B, T]
// one byte per key (a torch.bool's storage: 1 valid, 0 masked), m, l [B,
// H, T] f32.  Contiguous, on the stream's device, 16-byte aligned; D a
// multiple of 8 in [8, 128].
extern "C" int flash_mhsa_fwd(const void* q, const void* k, const void* v,
                              const uint8_t* key_mask, void* o, float* m,
                              float* l, int B, int T, int H, int D,
                              float sm_scale, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  if (flash::dmax_for(D) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return D <= 64 ? launch_bf16<1>(q, k, v, key_mask, o, m, l, B, T, H, D,
                                    sm_scale, s)
                   : launch_bf16<2>(q, k, v, key_mask, o, m, l, B, T, H, D,
                                    sm_scale, s);
  switch (flash::dmax_for(D)) {
    case 32:
      return launch_f32<32>(q, k, v, key_mask, o, m, l, B, T, H, D, sm_scale,
                            s);
    case 64:
      return launch_f32<64>(q, k, v, key_mask, o, m, l, B, T, H, D, sm_scale,
                            s);
    default:
      return launch_f32<128>(q, k, v, key_mask, o, m, l, B, T, H, D,
                             sm_scale, s);
  }
}
