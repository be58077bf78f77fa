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
// every sum is f32.  Keys and queries past T take no part.  Past a batch
// row's last valid key (kv_end, reduced from key_mask in each block's
// prologue) p = 0 and dS = 0 exactly in a row that has a valid key: the dq
// pass stops its key loop there, and a dk/dv block whose keys all lie past
// it writes zeros.
//
// What bounds it on this card: the bytes (q, k, v, o, dO read, dq, dk, dv
// written: ~106 MB at B=32, T=400, 8 heads of 64, 32 us at 3.35 TB/s),
// ahead of the five products (2.5x the forward's).  Design: the TPU's two
// calls, so no atomics and a deterministic result; both run on the stream
// from one entry point, two launches:
//   1. dq: one block per (b, h, 64 queries); its prologue computes delta_i
//      for the block's rows (and writes it for launch 2);
//   2. dk, dv: one block per (b, h, 64 keys).
// bf16 (every shipped recipe): one consumer warpgroup and one producer warp
// a block.  The resident operand (Q and dO in pass 1, K and V in pass 2)
// arrives once by TMA; the other streams through a 2-stage TMA ring with
// mbarriers (flash_sm90.cuh).  All five products are wgmma on the tensor
// cores: pass 1 S = Q.K^T and dP = dO.V^T from shared memory, then
// dQ += dS.K with dS in registers; pass 2 S^T = K.Q^T and dP^T = V.dO^T,
// then dV += P^T.dO and dK += dS^T.Q, P^T and dS^T in registers, dO and Q
// read MN-major.  Pass 2's consumers hold two accumulators (their
// registers set the blocks an SM).
// f32 (exactness checks at 1e-5): the CUDA cores, two threads per row,
// tiles converted into shared memory (flash_common.cuh), the same cuts.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using flash::kBlock;
using flash::kThreads;

// ---- float32: CUDA cores ----

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ key_mask,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         float* __restrict__ delta_out, float* __restrict__ dq,
                         int Tn, int H, int D, float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* v_s = k_s + kBlock * DMAX;               // [kBlock][DMAX]
  float* mk_s = v_s + kBlock * DMAX;              // 1 valid, 0 masked
  __shared__ int end_s;

  const int b = blockIdx.z, h = blockIdx.y;
  const int r = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int tq = blockIdx.x * kBlock + r;
  const bool in_seq = tq < Tn;
  const size_t rs = (size_t)H * D;
  const size_t head0 = (size_t)b * Tn * rs + (size_t)h * D;
  const size_t qrow = head0 + (size_t)tq * rs;
  const size_t stat = ((size_t)b * H + h) * Tn + tq;

  float4 qr[kG], dor[kG], acc[kG];
  flash::load_half<DMAX>(q + qrow, in_seq, D, hf, qr);
  flash::load_half<DMAX>(dout + qrow, in_seq, D, hf, dor);
  flash::load_half<DMAX>(o + qrow, in_seq, D, hf, acc);   // O, for delta
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
  const int kv_end = sm90::key_end(key_mask + (size_t)b * Tn, Tn, &end_s);

  for (int k0 = 0; k0 < (kv_end > 0 ? kv_end : Tn); k0 += kBlock) {
    const int nk = min(kBlock, Tn - k0);
    __syncthreads();
    flash::load_tile<DMAX>(k + head0 + (size_t)k0 * rs, rs, nk, D, k_s);
    flash::load_tile<DMAX>(v + head0 + (size_t)k0 * rs, rs, nk, D, v_s);
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
      flash::axpy_half<DMAX>(acc, ds, k_s + j * DMAX,
                             hf);
    }
  }
  if (in_seq) flash::store_half<DMAX>(dq + qrow, D, hf, acc, 1.f);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_mhsa_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ key_mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          const float* __restrict__ delta_in,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Tn, int H, int D, float scale) {
  constexpr int kG = DMAX / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBlock][DMAX]
  float* do_s = q_s + kBlock * DMAX;              // [kBlock][DMAX]
  float* m_s = do_s + kBlock * DMAX;              // [kBlock] row max
  float* il_s = m_s + kBlock;                     // [kBlock] 1 / row sum
  float* dl_s = il_s + kBlock;                    // [kBlock] delta
  __shared__ int end_s;

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
  flash::load_half<DMAX>(k + krow, in_seq, D, hf, kr);
  flash::load_half<DMAX>(v + krow, in_seq, D, hf, vr);
#pragma unroll
  for (int i = 0; i < kG; ++i) dka[i] = dva[i] = flash::zero4();
  // keys past the row's last valid key (in a row that has one) get p = 0
  // and dS = 0 from every query: the block writes zeros
  const int kv_end = sm90::key_end(key_mask + (size_t)b * Tn, Tn, &end_s);
  const int q_stop = kv_end > 0 && blockIdx.x * kBlock >= kv_end ? 0 : Tn;

  for (int q0 = 0; q0 < q_stop; q0 += kBlock) {
    const int nq = min(kBlock, Tn - q0);
    __syncthreads();
    flash::load_tile<DMAX>(q + head0 + (size_t)q0 * rs, rs, nq, D, q_s);
    flash::load_tile<DMAX>(dout + head0 + (size_t)q0 * rs, rs, nq, D,
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
      flash::axpy_half<DMAX>(dva, p, do_s + i * DMAX,
                             hf);
      const float ds = valid ? p * (dp - dl_s[i]) * scale : 0.f;
      flash::axpy_half<DMAX>(dka, ds, q_s + i * DMAX,
                             hf);
    }
  }
  if (in_seq) {
    flash::store_half<DMAX>(dk + krow, D, hf, dka, 1.f);
    flash::store_half<DMAX>(dv + krow, D, hf, dva, 1.f);
  }
}

// ---- bfloat16: tensor cores, TMA ----

// pass 1: dq (and delta).  Resident Q and dO; K and V stream up to kv_end.
template <int NB>
__global__ void __launch_bounds__(sm90::kThreads, 2)
flash_mhsa_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const uint8_t* __restrict__ key_mask, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ delta_out,
    __nv_bfloat16* __restrict__ dq, int Tn, int H, int D, float scale) {
  using namespace sm90;
  constexpr int kTile = NB * kBoxBytes;
  __shared__ Barriers bar;
  __shared__ int end_s;
  __shared__ float delta_s[kRows];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);   // Q, dO, then the K and V rings
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const uint8_t* mask_row = key_mask + (size_t)b * Tn;
  if (tid == 0) bar.init();
  const int kv_end = key_end(mask_row, Tn, &end_s);   // syncs the block
  const int n_tiles = ((kv_end > 0 ? kv_end : Tn) + kRows - 1) / kRows;

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      produce<NB>(bar, &tm_q, &tm_do, qt * kRows, &tm_k, &tm_v, q_s,
                  n_tiles, h, b);
    return;
  }

  // delta_i = dO_i . O_i: two threads a row, 8 dims at a time
  {
    const int row = qt * kRows + (tid >> 1);
    float part = 0.f;
    if (row < Tn) {
      const size_t at = (((size_t)b * Tn + row) * H + h) * D;
      for (int d = 8 * (tid & 1); d < D; d += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + d);
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + at + d);
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(o2[j]);
          const float2 gf = __bfloat1622float2(g2[j]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      delta_s[tid >> 1] = part;
      if (row < Tn) delta_out[((size_t)b * H + h) * Tn + row] = part;
    }
  }
  consumer_sync();

  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  // rows past T: q = 0 and 1/l = 0, so p = 0 (their dq is not written)
  float m[2], inv_l[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qt * kRows + r0 + 8 * rr;
    const size_t at = ((size_t)b * H + h) * Tn + row;
    m[rr] = row < Tn ? m_in[at] : 0.f;
    inv_l[rr] = row < Tn ? 1.f / l_in[at] : 0.f;
    dl[rr] = delta_s[r0 + 8 * rr];
  }
  const uint32_t q_a = smem_u32(q_s), do_a = q_a + kTile,
                 k_a = do_a + kTile, v_a = k_a + kStages * kTile;
  float acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  mbar_wait(&bar.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(&bar.full[st], (it / kStages) & 1);
    float s[32], dp[32];
    wgmma_fence();
    mma_rows<NB>(s, q_a, k_a + st * kTile);    // S = Q.K^T
    mma_rows<NB>(dp, do_a, v_a + st * kTile);  // dP = dO.V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = p (dP - delta) sm_scale at valid keys, 0 elsewhere (into s)
    const int k0 = it * kRows;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * c + c0 + e;
        const bool valid = key < Tn && mask_row[key];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * c + 2 * rr + e;
          const float p =
              __expf((valid ? s[i] * scale : flash::kMasked) - m[rr]) *
              inv_l[rr];
          s[i] = valid ? p * (dp[i] - dl[rr]) * scale : 0.f;
        }
      }
    uint32_t ds[4][4];
    acc_to_a(s, ds);

    fence_regs(acc);
    fence_regs(ds);
    wgmma_fence();
    mma_cols<NB>(acc, ds, k_a + st * kTile);   // dQ += dS.K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&bar.empty[st]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qt * kRows + r0 + 8 * rr;
    if (row < Tn)
      store_row<NB>(dq + (((size_t)b * Tn + row) * H + h) * D, acc, rr, 1.f,
                    D);
  }
}

// pass 2: dk and dv.  Resident K and V (this block's 64 keys); Q and dO
// stream over all T queries, with their m, 1/l and delta staged in shared
// memory by the consumers.  A block whose keys all lie past the row's last
// valid key (in a row that has one) writes zeros and returns.  The two
// accumulators take 64 (NB = 1) or 128 (NB = 2) registers a thread: two
// blocks an SM at NB = 1, one at NB = 2, so that neither spills.
template <int NB>
__global__ void __launch_bounds__(sm90::kThreads, NB == 1 ? 2 : 1)
flash_mhsa_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const uint8_t* __restrict__ key_mask, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ delta_in,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tn,
    int H, int D, float scale) {
  using namespace sm90;
  constexpr int kTile = NB * kBoxBytes;
  __shared__ Barriers bar;
  __shared__ int end_s;
  __shared__ float stats_s[2][3][kRows];   // [buffer][m, 1/l, delta][query]
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);   // K, V, then the Q and dO rings
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const uint8_t* mask_row = key_mask + (size_t)b * Tn;
  if (tid == 0) bar.init();
  const int kv_end = key_end(mask_row, Tn, &end_s);   // syncs the block
  if (kv_end > 0 && kt * kRows >= kv_end) {
    const int rows = min(kRows, Tn - kt * kRows), g = D / 8;
    for (int i = tid; i < rows * g; i += blockDim.x) {
      const int r = i / g;
      const size_t at =
          (((size_t)b * Tn + kt * kRows + r) * H + h) * D + 8 * (i - r * g);
      *reinterpret_cast<uint4*>(dk + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + at) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int n_tiles = (Tn + kRows - 1) / kRows;

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      produce<NB>(bar, &tm_k, &tm_v, kt * kRows, &tm_q, &tm_do, k_s,
                  n_tiles, h, b);
    return;
  }

  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  bool valid[2];   // this thread's keys r0 and r0 + 8
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kt * kRows + r0 + 8 * rr;
    valid[rr] = key < Tn && mask_row[key];
  }
  const uint32_t k_a = smem_u32(k_s), v_a = k_a + kTile, q_a = v_a + kTile,
                 do_a = q_a + kStages * kTile;
  float dk_acc[32 * NB], dv_acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(&bar.resident, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    // queries past T: m = 0, 1/l = 0, so p = 0
    if (tid < kRows) {
      const int i = it * kRows + tid;
      const size_t at = ((size_t)b * H + h) * Tn + i;
      stats_s[it & 1][0][tid] = i < Tn ? m_in[at] : 0.f;
      stats_s[it & 1][1][tid] = i < Tn ? 1.f / l_in[at] : 0.f;
      stats_s[it & 1][2][tid] = i < Tn ? delta_in[at] : 0.f;
    }
    consumer_sync();
    mbar_wait(&bar.full[st], (it / kStages) & 1);
    float s[32], dp[32];   // S^T and dP^T: rows keys, columns queries
    wgmma_fence();
    mma_rows<NB>(s, k_a, q_a + st * kTile);    // S^T = K.Q^T
    mma_rows<NB>(dp, v_a, do_a + st * kTile);  // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p into s, dS = p (dP - delta) sm_scale (0 at a masked key) into dp
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + c0 + e;
        const float mq = stats_s[it & 1][0][col];
        const float ilq = stats_s[it & 1][1][col];
        const float dlq = stats_s[it & 1][2][col];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * c + 2 * rr + e;
          const float p =
              __expf((valid[rr] ? s[i] * scale : flash::kMasked) - mq) * ilq;
          s[i] = p;
          dp[i] = valid[rr] ? p * (dp[i] - dlq) * scale : 0.f;
        }
      }
    uint32_t pa[4][4], ds[4][4];
    acc_to_a(s, pa);
    acc_to_a(dp, ds);

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(ds);
    wgmma_fence();
    mma_cols<NB>(dv_acc, pa, do_a + st * kTile);   // dV += P^T.dO
    mma_cols<NB>(dk_acc, ds, q_a + st * kTile);    // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&bar.empty[st]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kt * kRows + r0 + 8 * rr;
    if (key >= Tn) continue;
    const size_t at = (((size_t)b * Tn + key) * H + h) * D;
    store_row<NB>(dk + at, dk_acc, rr, 1.f, D);
    store_row<NB>(dv + at, dv_acc, rr, 1.f, D);
  }
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v,
               const uint8_t* key_mask, const void* o, const void* dout,
               const float* m, const float* l, float* delta, void* dq,
               void* dk, void* dv, int B, int Tn, int H, int D, float scale,
               cudaStream_t stream) {
  constexpr int tiles = 2 * kBlock * DMAX;
  constexpr int smem_dq = (tiles + kBlock) * sizeof(float);
  constexpr int smem_dkv = (tiles + 3 * kBlock) * sizeof(float);
  static const cudaError_t attr = [&] {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mhsa_bwd_dq_kernel<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_mhsa_bwd_dkv_kernel<DMAX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_dkv);
    return err;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  dim3 grid((Tn + kBlock - 1) / kBlock, H, B);
  flash_mhsa_bwd_dq_kernel<DMAX><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, key_mask, static_cast<const float*>(o), dot, m, l, delta,
      static_cast<float*>(dq), Tn, H, D, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_mhsa_bwd_dkv_kernel<DMAX>
      <<<grid, kThreads, smem_dkv, stream>>>(
          qt, kt, vt, key_mask, dot, m, l, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), Tn, H, D, scale);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_bf16(const void* q, const void* k, const void* v,
                const uint8_t* key_mask, const void* o, const void* dout,
                const float* m, const float* l, float* delta, void* dq,
                void* dk, void* dv, int B, int Tn, int H, int D, float scale,
                cudaStream_t stream) {
  // both passes: the resident pair, the ring of pairs, 1024-byte alignment
  constexpr int smem =
      (2 + 2 * sm90::kStages) * NB * sm90::kBoxBytes + 1024;
  static const cudaError_t attr = [&] {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mhsa_bwd_dq_bf16_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_mhsa_bwd_dkv_bf16_kernel<NB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    return err;
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_bthd(&tq, q, B, Tn, H, D);
  if (!err) err = sm90::encode_bthd(&tk, k, B, Tn, H, D);
  if (!err) err = sm90::encode_bthd(&tv, v, B, Tn, H, D);
  if (!err) err = sm90::encode_bthd(&tdo, dout, B, Tn, H, D);
  if (err) return err;
  using bf16 = __nv_bfloat16;
  dim3 grid((Tn + sm90::kRows - 1) / sm90::kRows, H, B);
  flash_mhsa_bwd_dq_bf16_kernel<NB><<<grid, sm90::kThreads, smem, stream>>>(
      tq, tk, tv, tdo, key_mask, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), m, l, delta, static_cast<bf16*>(dq),
      Tn, H, D, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_mhsa_bwd_dkv_bf16_kernel<NB><<<grid, sm90::kThreads, smem, stream>>>(
      tq, tk, tv, tdo, key_mask, m, l, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Tn, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv [B, T, H, D] (bf16 when is_bf16 else f32),
// key_mask [B, T] one byte per key (a torch.bool's storage), m, l (from
// flash_mhsa_fwd) and delta (scratch) [B, H, T] f32.  Contiguous, on the
// stream's device, 16-byte aligned; D a multiple of 8 in [8, 128].
extern "C" int flash_mhsa_bwd(const void* q, const void* k, const void* v,
                              const uint8_t* key_mask, const void* o,
                              const void* dout, const float* m,
                              const float* l, float* delta, void* dq,
                              void* dk, void* dv, int B, int T, int H, int D,
                              float sm_scale, int is_bf16, void* stream) {
  if (B == 0 || T == 0 || H == 0) return 0;
  if (flash::dmax_for(D) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return D <= 64 ? launch_bf16<1>(q, k, v, key_mask, o, dout, m, l, delta,
                                    dq, dk, dv, B, T, H, D, sm_scale, s)
                   : launch_bf16<2>(q, k, v, key_mask, o, dout, m, l, delta,
                                    dq, dk, dv, B, T, H, D, sm_scale, s);
  switch (flash::dmax_for(D)) {
    case 32:
      return launch_f32<32>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                            dv, B, T, H, D, sm_scale, s);
    case 64:
      return launch_f32<64>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                            dv, B, T, H, D, sm_scale, s);
    default:
      return launch_f32<128>(q, k, v, key_mask, o, dout, m, l, delta, dq, dk,
                             dv, B, T, H, D, sm_scale, s);
  }
}
