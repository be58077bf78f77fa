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
// Four routes, chosen by shape in ops/lstm_scan.py::cluster_plan and
// passed in as the plan's integers:
//
// The cluster route (bfloat16, H <= 512).  As for the forward scan, what
// bounds it on this card is the serial chain of each step: gate gradients,
// then the step's dgates must reach every block that computes a unit of
// dh, then the product of R x 4H x H, and only then the next step.  The
// bytes (0.08 ms at bucket 400) and products are far below T such chains.
// One cluster of C blocks per (direction, tile of R rows); block j owns
// the hidden units [j*u, (j+1)*u), u = H/C: their gate gradients and
// their dh.  Its slice of the weights, w_hh's rows [j*u, (j+1)*u) ([u, 4H]
// bf16, laid out by the wrapper in mma fragment order), is copied into
// shared memory once per launch by the bulk-copy engine.  Each step the
// block computes the dgates of its (unit, row) pairs from (dh, dc) carries
// in registers, writes them out in f32, and writes them rounded to bf16
// into its own slab ([R] rows of its 4 gate groups x u columns); one bulk
// copy per block of the cluster (cp.async.bulk shared::cta ->
// shared::cluster: distributed shared memory) then puts the slab into slab
// j of every block's dgates buffer, counted in bytes on the receiving
// block's mbarrier for that buffer.  (Sent as 16-byte stores instead, the
// 16 stores a lane each step cost more than the copy engine does.)  When
// its barrier has seen all C slabs of the step, a block
// computes dh for its units on the tensor cores (mma.sync m16n8k16: units
// as M, batch rows as N, 4H deep, its k-steps alternating between four
// accumulator chains so that their mma latencies overlap), the result
// landing in the registers of the lanes that own those (unit, row) pairs.
// No cluster barrier and no release fence sit in the loop.  The dgates
// buffers and the own slabs alternate by step parity: a block writes step
// s+2's dgates into a peer only after it has received that peer's step
// s+1 dgates, sent after the peer's step s product had read the buffer
// (and after the peer had received this block's step s slab, so the own
// slab of step s is free again).  Tiles of R =
// 8 rows (one mma n-tile) keep the exchange (8 x 4H bf16 a block and
// step) and the product short.  The next step's acts, cprev, dh_out and
// valid values are loaded into registers at the start of each step,
// hidden behind the exchange, the wait and the product.  Sums run in a
// fixed order (no atomics).
//
// The grid route (bfloat16, H > 512): the forward's grid (lstm_scan_fwd.cu)
// with w_hh's rows [j*u, (j+1)*u) ([u, 4H], u = 16) as block j's resident
// slice in shared memory.  Each step a block computes the dgates of its
// units from the (dh, dc) carries, writes them rounded to bf16 into the
// step's exchange buffer as its slab (4 gate groups of u, so the K order
// is block by block as in the cluster route), arrives on its group's
// counter, and once all N have arrived streams the group's rows of
// round(dgates) ([R][4H]) through the ring and adds their product with its
// slice to the dh carry (a warp a work unit of 16 units x 8 rows, the
// k-steps split among warps where there are fewer than 8, the parts added
// in a fixed order).  The exchange is four times the forward's (4H a row):
// what a block reads a step, [R][4H] bf16 from L2, sets the step's time
// above the barrier.
//
// The float32 grid route (float32 from H=192 where the grid fits the
// card): the forward's float32 grid with w_hh's rows [j*u, (j+1)*u), u =
// 8, as block j's resident slice ([4H][8] f32, k-major: 128 KB at
// H=1024), and dgates exchanged in float32 as they are (the reference's
// float32 rounds nothing), k-major in the natural gate-column order
// ([4H][64] a sub-tile of 64 rows).  A step reads the group's whole
// dgates, 64 x 4H f32 (1 MB a block at H=1024, 128 MB through L2 for the
// 128 blocks), fed by the producer warp's bulk copies under the 64 x 8 x
// 4H FMAs, as the forward's h is.  A lane holds 4 rows x 4
// units in registers (a 16-byte word of dgates and one of the weights
// feed 16 FMAs), one warp covers the sub-tile's 64 x 8 outputs, and the 8
// warps are 8 k-parts of each chunk, added in a fixed order by the pairs'
// owners before the gate gradients.
//
// The CUDA-core route (the exactness checks, and float32 and bfloat16
// where no grid fits): one block owns (direction, tile of kRows batch rows) and
// loops over all T with (dh, dc) in shared memory; the
// wrapper hands the weights transposed, [D,4H,H], so the product reduces
// over rows of a contiguous matrix like the forward's: each thread owns a
// 16-byte group of output units over one slice of the 4H inputs, the
// slice partials summed in a fixed order.

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


// ---- the cluster route (bf16) ----

// the lane's acts (4 gates), cprev, dh_out of its pairs (unit hh, row e)
// and valid of its rows at step t (zeros past B)
__device__ __forceinline__ void fetch_bwd(
    const float* __restrict__ act, const float* __restrict__ cp,
    const float* __restrict__ dho, const float* __restrict__ valid, int t,
    int B, int H, int row0, int rbase, const int (&unit)[2],
    float (&a)[4][4], float (&c)[4], float (&g)[4], float (&v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + rbase + e;
    const bool live = row < B;
    const size_t base = (size_t)t * B + row;
    v[e] = live ? valid[base] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = hh * 2 + e;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[p][q] = live ? act[base * 4 * H + q * H + unit[hh]] : 0.f;
      c[p] = live ? cp[base * H + unit[hh]] : 0.f;
      g[p] = live ? dho[base * H + unit[hh]] : 0.f;
    }
  }
}

// One cluster per (direction, tile of R rows), block j = rank in the
// cluster.  Warp (mt, ng) owns the units j*u + 16*mt + [0, 16) and the
// rows 8*ng + [0, 8) of the tile; lane pairs: units lane/4 + 8*hh, rows
// 2*(lane%4) + e, as mma's accumulator holds them.  The 4H-deep product
// runs in kChains chains over alternate k-steps (their latencies overlap),
// added in a fixed order.  Step s's round(dgates) go to buffer s & 1 (C
// slabs of [R][4u + kPad], each row gate by gate); its mbarrier
// bars[1 + (s & 1)] completes a phase when every block's slab of that step
// has landed.
__global__ void __launch_bounds__(lstm::kClusterThreads)
lstm_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ w_frag,  // [D,C,u*4H]
                        const float* __restrict__ valid,     // [T,B]
                        const float* __restrict__ acts,      // [D,T,B,4H]
                        const float* __restrict__ cprev,     // [D,T,B,H]
                        const float* __restrict__ dh_out,    // [D,T,B,H]
                        float* __restrict__ dgates,          // [D,T,B,4H]
                        int T, int B, int H, int R, int reverse_mask) {
  using namespace lstm;
  constexpr int kChains = 4;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int C = cluster_size();
  const int j = cluster_rank();
  const int u = H / C, H4 = 4 * H, MT = u / 16, SW = 4 * u + kPad;
  const int slab = R * SW;          // one block's rows of round(dgates)
  const size_t wbytes = (size_t)u * H4 * 2;
  const uint32_t step_bytes = (uint32_t)C * slab * 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  const uint4* w_s = reinterpret_cast<const uint4*>(smem_b + kHeader);
  __nv_bfloat16* g_s =              // [2][C][R][SW] round(dgates) by parity
      reinterpret_cast<__nv_bfloat16*>(smem_b + kHeader + wbytes);
  __nv_bfloat16* own_s = g_s + 2 * C * slab;   // [2][R][SW] this block's

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % MT, ng = warp / MT;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * R;
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B;
  const float* act = acts + (size_t)d * seq * H4;
  const float* cp = cprev + (size_t)d * seq * H;
  const float* dho = dh_out + (size_t)d * seq * H;
  float* dg = dgates + (size_t)d * seq * H4;
  const int ul[2] = {mt * 16 + (lane >> 2), mt * 16 + (lane >> 2) + 8};
  const int unit[2] = {j * u + ul[0], j * u + ul[1]};
  const int rbase = ng * 8 + 2 * (lane & 3);

  init_barriers(bars, 3);
  if (threadIdx.x == 0) {        // steps 0 and 1 (buffers 0 and 1); the
    if (T > 1) expect_bytes(&bars[1], step_bytes);   // last step sends
    if (T > 2) expect_bytes(&bars[2], step_bytes);   // nothing
  }
  load_resident(smem_b + kHeader, w_frag + ((size_t)d * C + j) * u * H4,
                (uint32_t)wbytes, &bars[0]);
  float dh[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
  float a[4][4], c0[4], g0[4], v[2];
  fetch_bwd(act, cp, dho, valid, rev ? 0 : T - 1, B, H, row0, rbase, unit, a,
            c0, g0, v);
  cluster_sync();     // every block's barriers are set before a remote store

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    float an[4][4], cn[4], gn[4], vn[2];
    if (s + 1 < T)
      fetch_bwd(act, cp, dho, valid, rev ? t + 1 : t - 1, B, H, row0, rbase,
                unit, an, cn, gn, vn);

    // gate gradients of the lane's pairs, the dc carry and the (1-v) part
    // of the dh carry
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = hh * 2 + e;
        const int r = rbase + e;
        const int row = row0 + r;
        const float ig = a[p][0], fg = a[p][1], gg = a[p][2], og = a[p][3];
        const float tc = tanhf(fg * c0[p] + ig * gg);
        const float dh_new = v[e] * (dh[p] + g0[p]);
        const float dc_new = dh_new * og * (1.f - tc * tc) + v[e] * dc[p];
        const float dq[4] = {dc_new * gg * ig * (1.f - ig),
                             dc_new * c0[p] * fg * (1.f - fg),
                             dc_new * ig * (1.f - gg * gg),
                             dh_new * tc * og * (1.f - og)};
        float* out = dg + ((size_t)t * B + row) * H4 + unit[hh];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (row < B) out[q * H] = dq[q];
          own_s[(s & 1) * slab + r * SW + q * u + ul[hh]] = bf16(dq[q]);
        }
        dh[p] = (1.f - v[e]) * dh[p];
        dc[p] = (1.f - v[e]) * dc[p] + dc_new * fg;
      }

    if (s + 1 < T) {   // the last step's dh is not needed
      // this block's slab into slab j of this step's dgates buffer of
      // every block of the cluster, this one included
      const int cb = s & 1;
      send_slab(smem_u32(g_s + ((size_t)cb * C + j) * slab),
                smem_u32(own_s + cb * slab), (uint32_t)slab * 2,
                smem_u32(&bars[1 + cb]), C);
      wait_phase(&bars[1 + cb], (s >> 1) & 1);   // every block's have landed
      if (threadIdx.x == 0 && s + 3 < T)
        expect_bytes(&bars[1 + cb], step_bytes);   // for step s + 2

      // dh[units, rows] += w_slice . round(dgates)^T on the tensor cores,
      // k-steps slab by slab (4u a slab, a multiple of 4 k-steps)
      const __nv_bfloat16* gb = g_s + (size_t)cb * C * slab + ng * 8 * SW;
      const uint4* wp = w_s + (size_t)mt * (H4 / 16) * 32 + lane;
      float acc[kChains][4];
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[ch][q] = 0.f;
      for (int jj = 0; jj < C; ++jj, gb += slab)
#pragma unroll 2
        for (int kk = 0; kk < 4 * u; kk += 16 * kChains, wp += 32 * kChains)
#pragma unroll
          for (int ch = 0; ch < kChains; ++ch) {
            uint32_t b0, b1;
            b_frag(gb, SW, kk + 16 * ch, b0, b1);
            mma_bf16(acc[ch], wp[32 * ch], b0, b1);
          }
      // acc[.][2*hh + e] is (unit hh, row e): the pair order of dh
      static_assert(kChains == 4, "the chains are added pairwise below");
#pragma unroll
      for (int p = 0; p < 4; ++p)
        dh[p] += (acc[0][p] + acc[1][p]) + (acc[2][p] + acc[3][p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      c0[p] = cn[p];
      g0[p] = gn[p];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[p][q] = an[p][q];
    }
    v[0] = vn[0];
    v[1] = vn[1];
  }
  cluster_sync();       // no block leaves while a peer may still store to it
}

int launch_cluster(const void* w_frag, const float* valid, const float* acts,
                   const float* cprev, const float* dh_out, float* dgates,
                   int D, int T, int B, int H, int reverse_mask, int C, int R,
                   cudaStream_t stream) {
  const int threads = lstm::bwd_cluster_threads(H, C, R);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  dim3 grid(C * ((B + R - 1) / R), D);
  return (int)lstm::launch_clusters(
      lstm_bwd_cluster_kernel, grid, threads,
      lstm::bwd_cluster_smem(H, C, R), C, stream,
      static_cast<const __nv_bfloat16*>(w_frag), valid, acts, cprev, dh_out,
      dgates, T, B, H, R, reverse_mask);
}


// ---- the grid route (bf16, H > 512) ----

// One block per (unit slice j, row group g, direction d): grid (N, G, D).
// Warp w takes work unit w % W (16 units mt x 8 rows nt of the sub-tile)
// and the k-steps kk with kk % ksplit == w / W (ksplit = 8 / W); lane
// pairs: units 16*mt + lane/4 + 8*hh, rows 8*nt + 2*(lane%4) + e, as mma's
// accumulator holds them.  Step s first adds round(dgates_{s-1}) .
// w_hh^T, read from exchange buffer (s-1) & 1, to the dh carry (no product
// at s = 0), then computes dgates_s and writes them, rounded, into buffer
// s & 1 as block j's slab (its 4 gate groups of u, columns [4u*j,
// 4u*(j+1))) before arriving: a block writes buffer s & 1 only after the
// count of step s-1, i.e. after every block's step s-1 arrival, which each
// made after its step s-1 product had read that buffer.
__global__ void __launch_bounds__(lstm::kGridThreads, 1)
lstm_bwd_grid_kernel(const __nv_bfloat16* __restrict__ w_frag,  // [D,N,u*4H]
                     const float* __restrict__ valid,     // [T,B]
                     const float* __restrict__ acts,      // [D,T,B,4H]
                     const float* __restrict__ cprev,     // [D,T,B,H]
                     const float* __restrict__ dh_out,    // [D,T,B,H]
                     float* __restrict__ dgates,          // [D,T,B,4H]
                     __nv_bfloat16* __restrict__ xch,     // [2,D,G*R,4H]
                     unsigned* __restrict__ ctr,          // [D*G], zeroed
                     int T, int B, int H, int R, int RS, int KC, int S,
                     int reverse_mask) {
  using namespace lstm;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int N = gridDim.x, G = gridDim.y, D = gridDim.z;
  const int j = blockIdx.x, g = blockIdx.y, d = blockIdx.z;
  const int u = H / N, H4 = 4 * H, MT = u / 16;
  const int W = MT * (RS / 8), ksplit = kGridWarps / W;
  const int KSC = KC / 16, SW = KC + kPad;
  const GridLayout L = grid_layout(true, H, u, R, RS, KC, S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  const uint4* w_s = reinterpret_cast<const uint4*>(smem_b + kGridHeader);
  __nv_bfloat16* ring_s = reinterpret_cast<__nv_bfloat16*>(smem_b + L.ring);
  float* a_s = reinterpret_cast<float*>(smem_b + L.in);   // [RS][4u] acts
  float* cp_s = a_s + RS * 4 * u;                          // [RS][u] cprev
  float* g_s = cp_s + RS * u;                              // [RS][u] dh_out
  float* v_s = g_s + RS * u;                               // [RS] valid
  float* dh_s = reinterpret_cast<float*>(smem_b + L.carry);  // [R][u]
  float* dc_s = dh_s + R * u;                                // [R][u]
  float* part_s = reinterpret_cast<float*>(smem_b + L.part);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wu = warp % W, kp = warp / W;
  const int mt = wu % MT, nt = wu / MT;
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B, xrows = (size_t)G * R;
  const float* act = acts + (size_t)d * seq * H4;
  const float* cpv = cprev + (size_t)d * seq * H;
  const float* dho = dh_out + (size_t)d * seq * H;
  float* dg = dgates + (size_t)d * seq * H4;
  unsigned* my_ctr = ctr + d * G + g;
  const int ul[2] = {mt * 16 + (lane >> 2), mt * 16 + (lane >> 2) + 8};

  // the lane's dgates of a sub-tile at step t (pair 2*hh + e: unit hh,
  // row e), in f32: whole 32-byte sectors, 8 units of a row a quarter warp
  float out[4][4];
  auto store = [&](int t, int r0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + nt * 8 + 2 * (lane & 3) + e;
      if (row >= B) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dg[((size_t)t * B + row) * H4 + q * H + j * u + ul[hh]] =
              out[2 * hh + e][q];
    }
  };

  for (int i = threadIdx.x; i < 2 * R * u; i += blockDim.x) dh_s[i] = 0.f;
  init_barriers(bars, 1);
  load_resident(smem_b + kGridHeader,
                w_frag + ((size_t)d * N + j) * u * H4,
                (uint32_t)((size_t)u * H4 * 2), &bars[0]);

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    for (int r0 = g * R; r0 < g * R + R; r0 += RS) {
      // this step's acts (4 gate groups of u units), cprev, dh_out and
      // valid of the sub-tile's rows, in flight while the block waits and
      // multiplies
      const int pr = 3 * u / 2;            // 16-byte pieces a row
      for (int i = threadIdx.x; i < RS * pr; i += blockDim.x) {
        const int r = i / pr, p = i - r * pr;
        const int row = r0 + r;
        const bool live = row < B;
        const size_t base = (size_t)t * B + (live ? row : 0);
        if (p < u) {                       // acts: gate p / (u/4)
          const int q = p / (u / 4), k = p % (u / 4);
          cp16(a_s + r * 4 * u + q * u + 4 * k,
               act + base * H4 + q * H + j * u + 4 * k, live);
        } else if (p < 5 * u / 4) {
          const int k = p - u;
          cp16(cp_s + r * u + 4 * k, cpv + base * H + j * u + 4 * k, live);
        } else {
          const int k = p - 5 * u / 4;
          cp16(g_s + r * u + 4 * k, dho + base * H + j * u + 4 * k, live);
        }
      }
      for (int r = threadIdx.x; r < RS; r += blockDim.x)
        cp4(v_s + r, valid + (size_t)t * B + (r0 + r < B ? r0 + r : 0),
            r0 + r < B);
      cp_commit();

      // dh[units, rows] += w_slice . round(dgates_{s-1})^T, four chains
      // over alternate k-steps, added in a fixed order
      float acc[4][4] = {};
      if (s > 0) {
        if (r0 == g * R) grid_wait(my_ctr, (unsigned)N * s);
        ring(ring_s,
             xch + (((size_t)((s - 1) & 1) * D + d) * xrows + r0) * H4, RS,
             H4, KC, S, [&](int c, const __nv_bfloat16* stage) {
               const __nv_bfloat16* gb = stage + nt * 8 * SW;
               const uint4* wp = w_s + ((size_t)mt * (H4 / 16) +
                                        (size_t)c * KSC) * 32 + lane;
               auto step = [&](int kk, float(&a)[4]) {
                 uint32_t b0, b1;
                 b_frag(gb, SW, kk * 16, b0, b1);
                 mma_bf16(a, wp[kk * 32], b0, b1);
               };
               int kk = kp;
#pragma unroll 2
               for (; kk + 3 * ksplit < KSC; kk += 4 * ksplit) {
                 step(kk, acc[0]);
                 step(kk + ksplit, acc[1]);
                 step(kk + 2 * ksplit, acc[2]);
                 step(kk + 3 * ksplit, acc[3]);
               }
               for (; kk < KSC; kk += ksplit) step(kk, acc[0]);
             });
      }
      float sum[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sum[q] = (acc[0][q] + acc[1][q]) + (acc[2][q] + acc[3][q]);
      if (kp > 0) {
        float* p = part_s + (((size_t)(kp - 1) * W + wu) * 32 + lane) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = sum[q];
      }
      cp_wait<0>();
      __syncthreads();

      if (kp == 0) {
        for (int k = 1; k < ksplit; ++k) {
          const float* p = part_s + (((size_t)(k - 1) * W + wu) * 32 + lane) * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[q] += p[q];
        }
        // gate gradients of the lane's pairs (sum[2*hh + e] is unit hh,
        // row e), the dc carry and the (1-v) part of the dh carry;
        // round(dgates) into the exchange, dgates in registers until
        // stored
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int rr = nt * 8 + 2 * (lane & 3) + e;
            const int row = r0 + rr;
            const float* ap = a_s + rr * 4 * u + ul[hh];
            const float ig = ap[0], fg = ap[u], gg = ap[2 * u], og = ap[3 * u];
            const float c0 = cp_s[rr * u + ul[hh]];
            const float v = v_s[rr];
            float* dhc = dh_s + (row - g * R) * u + ul[hh];
            float* dcc = dc_s + (row - g * R) * u + ul[hh];
            const float dh = s > 0 ? *dhc + sum[2 * hh + e] : *dhc;
            const float dc = *dcc;
            const float tc = tanhf(fg * c0 + ig * gg);
            const float dh_new = v * (dh + g_s[rr * u + ul[hh]]);
            const float dc_new = dh_new * og * (1.f - tc * tc) + v * dc;
            float* dq = out[2 * hh + e];
            dq[0] = dc_new * gg * ig * (1.f - ig);
            dq[1] = dc_new * c0 * fg * (1.f - fg);
            dq[2] = dc_new * ig * (1.f - gg * gg);
            dq[3] = dh_new * tc * og * (1.f - og);
            if (s + 1 < T)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                xch[(((size_t)(s & 1) * D + d) * xrows + row) * H4 +
                    4 * u * j + q * u + ul[hh]] = bf16(dq[q]);
            *dhc = (1.f - v) * dh;
            *dcc = (1.f - v) * dc + dc_new * fg;
          }
        // a sub-tile's dgates go out once the next one needs the
        // registers; the last one's after the arrival
        if (r0 + RS < g * R + R) store(t, r0);
      }
      __syncthreads();   // the ring, inputs and partials are free again
    }
    if (s + 1 < T) grid_arrive(my_ctr);
    if (kp == 0) store(t, g * R + R - RS);
  }
}


// ---- the float32 grid route ----

// One block per (unit slice j, row group g, direction d): grid (N, G, D),
// u = kF32Units.  Product: warp w is k-part w (the chunk's k values w, w +
// 8, ...); lane (rg, ug) = (lane % 16, lane / 16) owns the rows 4*rg +
// [0, 4) of the sub-tile and the units 4*ug + [0, 4).  Gate math: thread p
// owns the pairs (unit p % u, row p / u) and (the same + 256).  Step s
// first adds dgates_{s-1} . w_hh^T, read from exchange buffer (s-1) & 1,
// to the dh carry (no product at s = 0), then computes dgates_s and
// writes them into buffer s & 1 (k = gate * H + unit) before arriving, as
// the bf16 grid does.
__global__ void __launch_bounds__(lstm::kF32Threads, 1)
lstm_bwd_grid_f32_kernel(const float* __restrict__ w_frag,    // [D,N,4H*u]
                         const float* __restrict__ valid,     // [T,B]
                         const float* __restrict__ acts,      // [D,T,B,4H]
                         const float* __restrict__ cprev,     // [D,T,B,H]
                         const float* __restrict__ dh_out,    // [D,T,B,H]
                         float* __restrict__ dgates,          // [D,T,B,4H]
                         float* __restrict__ xch,   // [2,D,G*R/64,4H,64]
                         unsigned* __restrict__ ctr,          // [D*G], zeroed
                         int T, int B, int H, int R, int KC, int S,
                         int reverse_mask) {
  using namespace lstm;
  constexpr int u = kF32Units, RS = kF32Sub, KP = kGridWarps;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int N = gridDim.x, G = gridDim.y, D = gridDim.z;
  const int j = blockIdx.x, g = blockIdx.y, d = blockIdx.z;
  const int H4 = 4 * H;
  const F32Layout L = f32_layout(true, H, R, KC, S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  uint64_t* full = bars + 1;                    // [kF32MaxStages]
  uint64_t* empty = full + kF32MaxStages;       // [kF32MaxStages]
  const float* w_s = reinterpret_cast<const float*>(smem_b + kF32Header);
  float* ring_s = reinterpret_cast<float*>(smem_b + L.ring);
  float* a_s = reinterpret_cast<float*>(smem_b + L.in);   // [RS][4u] acts
  float* cp_s = a_s + RS * 4 * u;                          // [RS][u] cprev
  float* g_s = cp_s + RS * u;                              // [RS][u] dh_out
  float* v_s = g_s + RS * u;                               // [RS] valid
  float* dh_s = reinterpret_cast<float*>(smem_b + L.carry);  // [R][u]
  float* dc_s = dh_s + R * u;                                // [R][u]
  float* part_s = reinterpret_cast<float*>(smem_b + L.ring);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool compute = warp < kGridWarps;      // not the producer warp
  const int kp = warp, rg = lane % 16, ug = lane / 16;
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B, nsub = (size_t)G * R / RS;
  uint32_t chunks = 0;                          // put through the ring
  const float* act = acts + (size_t)d * seq * H4;
  const float* cpv = cprev + (size_t)d * seq * H;
  const float* dho = dh_out + (size_t)d * seq * H;
  float* dg = dgates + (size_t)d * seq * H4;
  unsigned* my_ctr = ctr + d * G + g;
  // sub-tile st's exchanged dgates of step parity par: [4H][RS]
  auto xbuf = [&](int par, int st) {
    return xch + (((size_t)par * D + d) * nsub + st) * (size_t)H4 * RS;
  };

  // the thread's dgates of a sub-tile at step t (pair e), stored after the
  // arrival: 8 threads write the 8 units of a row and gate, one sector
  float out[kF32Pairs][4];
  auto store = [&](int t, int r0) {
    if (!compute) return;
#pragma unroll
    for (int e = 0; e < kF32Pairs; ++e) {
      const int p = threadIdx.x + e * kGridThreads;
      const int row = r0 + p / u;
      if (row >= B) continue;
      float* o = dg + ((size_t)t * B + row) * H4 + j * u + p % u;
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q * H] = out[e][q];
    }
  };

  for (int i = threadIdx.x; i < 2 * R * u; i += blockDim.x) dh_s[i] = 0.f;
  init_f32_barriers(bars);
  load_resident(smem_b + kF32Header, w_frag + ((size_t)d * N + j) * u * H4,
                (uint32_t)((size_t)u * H4 * 4), &bars[0]);

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    for (int r0 = g * R; r0 < g * R + R; r0 += RS) {
      const int st = r0 / RS;
      // this step's acts (4 gate groups of u units), cprev, dh_out and
      // valid of the sub-tile's rows, in flight while the block waits and
      // multiplies
      const int pr = 3 * u / 2;            // 16-byte pieces a row
      for (int i = threadIdx.x; i < RS * pr; i += blockDim.x) {
        const int r = i / pr, p = i - r * pr;
        const int row = r0 + r;
        const bool live = row < B;
        const size_t base = (size_t)t * B + (live ? row : 0);
        if (p < u) {                       // acts: gate p / (u/4)
          const int q = p / (u / 4), k = p % (u / 4);
          cp16(a_s + r * 4 * u + q * u + 4 * k,
               act + base * H4 + q * H + j * u + 4 * k, live);
        } else if (p < 5 * u / 4) {
          const int k = p - u;
          cp16(cp_s + r * u + 4 * k, cpv + base * H + j * u + 4 * k, live);
        } else {
          const int k = p - 5 * u / 4;
          cp16(g_s + r * u + 4 * k, dho + base * H + j * u + 4 * k, live);
        }
      }
      for (int r = threadIdx.x; r < RS; r += blockDim.x)
        cp4(v_s + r, valid + (size_t)t * B + (r0 + r < B ? r0 + r : 0),
            r0 + r < B);
      cp_commit();

      // dh[rows, units] += dgates_{s-1}[rows, 4H] . w_slice[4H, u]
      float acc[4][4] = {};
      if (s > 0) {
        if (r0 == g * R) grid_wait(my_ctr, (unsigned)N * s);
        ring_f32(ring_s, xbuf((s - 1) & 1, st), H4, KC, S, full, empty,
                 chunks, [&](int c, const float* stage) {
                   const float* gp = stage + rg * 4;
                   const float* wp = w_s + (size_t)c * KC * u + ug * 4;
#pragma unroll 4
                   for (int kk = kp; kk < KC; kk += KP) {
                     const float4 g4 =
                         *reinterpret_cast<const float4*>(gp + kk * RS);
                     const float4 w4 =
                         *reinterpret_cast<const float4*>(wp + kk * u);
                     const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
                     const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                     for (int i = 0; i < 4; ++i)
#pragma unroll
                       for (int m = 0; m < 4; ++m)
                         acc[i][m] = fmaf(gv[i], wv[m], acc[i][m]);
                   }
                 });
        __syncthreads();   // the ring's bytes take the partial sums
      }
      // the partial sums: row 4 * rg + i, units 4 * ug + [0, 4)
      if (compute)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(part_s + (size_t)kp * 4 * kF32BwdI +
                                     i * kF32BwdI + ug * kF32BwdHalf +
                                     rg * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      cp_wait<0>();
      __syncthreads();

      // each pair: the k-parts added in order into the dh carry, the gate
      // gradients, the dc carry and the (1-v) part of the dh carry;
      // dgates into the exchange, and in registers until stored
      if (compute)
#pragma unroll
        for (int e = 0; e < kF32Pairs; ++e) {
          const int p = threadIdx.x + e * kGridThreads;
          const int ul = p % u, rr = p / u;
          const float* pp = part_s + (rr % 4) * kF32BwdI +
                            (ul / 4) * kF32BwdHalf + (rr / 4) * 4 + ul % 4;
          float sum = pp[0];
#pragma unroll
          for (int k = 1; k < KP; ++k) sum += pp[k * 4 * kF32BwdI];
          const float* ap = a_s + rr * 4 * u + ul;
          const float ig = ap[0], fg = ap[u], gg = ap[2 * u], og = ap[3 * u];
          const float c0 = cp_s[rr * u + ul];
          const float v = v_s[rr];
          float* dhc = dh_s + (r0 - g * R + rr) * u + ul;
          float* dcc = dc_s + (r0 - g * R + rr) * u + ul;
          const float dh = s > 0 ? *dhc + sum : *dhc;
          const float dc = *dcc;
          const float tc = tanhf(fg * c0 + ig * gg);
          const float dh_new = v * (dh + g_s[rr * u + ul]);
          const float dc_new = dh_new * og * (1.f - tc * tc) + v * dc;
          float* dq = out[e];
          dq[0] = dc_new * gg * ig * (1.f - ig);
          dq[1] = dc_new * c0 * fg * (1.f - fg);
          dq[2] = dc_new * ig * (1.f - gg * gg);
          dq[3] = dh_new * tc * og * (1.f - og);
          if (s + 1 < T) {
            float* x = xbuf(s & 1, st) + (size_t)(j * u + ul) * RS + rr;
#pragma unroll
            for (int q = 0; q < 4; ++q) x[(size_t)q * H * RS] = dq[q];
          }
          *dhc = (1.f - v) * dh;
          *dcc = (1.f - v) * dc + dc_new * fg;
        }
      // a sub-tile's dgates go out once the next one needs the registers;
      // the last one's after the arrival
      if (r0 + RS < g * R + R) store(t, r0);
      __syncthreads();   // the ring, inputs and partials are free again
    }
    if (s + 1 < T) grid_arrive(my_ctr);
    store(t, g * R + R - RS);
  }
}

int launch_grid_f32_bwd(const void* w_frag, const float* valid,
                        const float* acts, const float* cprev,
                        const float* dh_out, float* dgates, void* xch,
                        unsigned* ctr, int D, int T, int B, int H,
                        int reverse_mask, int u, int G, int R, int RS, int KC,
                        int S, cudaStream_t stream) {
  if (!lstm::grid_f32_plan_ok(true, H, u, R, RS, KC, S) || G < 1 ||
      (long long)G * R < B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm::f32_layout(true, H, R, KC, S).total;
  return (int)lstm::launch_grid_threads(
      lstm_bwd_grid_f32_kernel, dim3(H / u, G, D), lstm::kF32Threads, smem,
      stream,
      static_cast<const float*>(w_frag), valid, acts, cprev, dh_out, dgates,
      static_cast<float*>(xch), ctr, T, B, H, R, KC, S, reverse_mask);
}

int launch_grid_bwd(const void* w_frag, const float* valid, const float* acts,
                    const float* cprev, const float* dh_out, float* dgates,
                    void* xch, unsigned* ctr, int D, int T, int B, int H,
                    int reverse_mask, int u, int G, int R, int RS, int KC,
                    int S, cudaStream_t stream) {
  if (!lstm::grid_plan_ok(true, H, u, R, RS, KC, S) || G < 1 ||
      (long long)G * R < B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm::grid_layout(true, H, u, R, RS, KC, S).total;
  return (int)lstm::launch_grid(
      lstm_bwd_grid_kernel, dim3(H / u, G, D), smem, stream,
      static_cast<const __nv_bfloat16*>(w_frag), valid, acts, cprev, dh_out,
      dgates, static_cast<__nv_bfloat16*>(xch), ctr, T, B, H, R, RS, KC, S,
      reverse_mask);
}
}  // namespace

// valid [T,B] f32 0/1, acts [D,T,B,4H], cprev and dh_out [D,T,B,H],
// dgates [D,T,B,4H], all f32 (the grid routes have their own entries,
// lstm_scan_bwd_grid and lstm_scan_bwd_grid_f32).  cluster = 0: the CUDA-core route, w_t
// [D,4H,H] = w_hh transposed (bf16 when w_is_bf16 else f32).  cluster =
// C > 0: the cluster route with clusters of C blocks and R = rows batch
// rows; w_t is bf16 w_hh in the wrapper's fragment order
// [D,C,u*4H].  A plan the route cannot take returns cudaErrorInvalidValue.
// Contiguous, on the stream's device.
extern "C" int lstm_scan_bwd(const void* w_t, const float* valid,
                             const float* acts, const float* cprev,
                             const float* dh_out, float* dgates, int D, int T,
                             int B, int H, int reverse_mask, int w_is_bf16,
                             int cluster, int rows, void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 0) {
    if (!w_is_bf16) return (int)cudaErrorInvalidValue;
    return launch_cluster(w_t, valid, acts, cprev, dh_out, dgates, D, T, B,
                          H, reverse_mask, cluster, rows, s);
  }
  if (w_is_bf16)
    return launch<__nv_bfloat16>(w_t, valid, acts, cprev, dh_out, dgates, D,
                                 T, B, H, reverse_mask, s);
  return launch<float>(w_t, valid, acts, cprev, dh_out, dgates, D, T, B, H,
                       reverse_mask, s);
}

// The grid route (bf16, H > 512): valid, acts, cprev, dh_out and dgates as
// lstm_scan_bwd; w_frag bf16 w_hh in the fragment order of H/units pieces
// [D, H/units, units*4H]; xch bf16 scratch [2, D, groups*rows, 4H]; ctr
// [D*groups] u32, zeroed; the plan's integers as lstm_scan_fwd_grid's.
extern "C" int lstm_scan_bwd_grid(const void* w_frag, const float* valid,
                                  const float* acts, const float* cprev,
                                  const float* dh_out, float* dgates,
                                  void* xch, unsigned* ctr, int D, int T,
                                  int B, int H, int reverse_mask, int units,
                                  int groups, int rows, int sub, int chunk,
                                  int stages, void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  return launch_grid_bwd(w_frag, valid, acts, cprev, dh_out, dgates, xch,
                         ctr, D, T, B, H, reverse_mask, units, groups, rows,
                         sub, chunk, stages, (cudaStream_t)stream);
}

// Blocks of the backward grid plan one SM holds, and the card's SMs.
extern "C" int lstm_scan_bwd_grid_occupancy(int H, int units, int rows,
                                            int sub, int chunk, int stages,
                                            int* per_sm, int* sms) {
  if (!lstm::grid_plan_ok(true, H, units, rows, sub, chunk, stages))
    return (int)cudaErrorInvalidValue;
  return (int)lstm::grid_occupancy(
      lstm_bwd_grid_kernel,
      lstm::grid_layout(true, H, units, rows, sub, chunk, stages).total,
      per_sm, sms);
}

// How many clusters of the backward cluster route's plan the card holds at
// once, into *clusters.
extern "C" int lstm_scan_bwd_occupancy(int H, int cluster, int rows,
                                       int* clusters) {
  const int threads = lstm::bwd_cluster_threads(H, cluster, rows);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  return (int)lstm::max_clusters(lstm_bwd_cluster_kernel, threads,
                                 lstm::bwd_cluster_smem(H, cluster, rows),
                                 cluster, clusters);
}

// The float32 grid route: the arguments of lstm_scan_bwd_grid, with w_frag
// f32 w_hh's rows in H/units slices [D, H/units, 4H*units] (block j's
// slice [4H][u], k-major) and xch f32 scratch [2, D, groups*rows/sub, 4H,
// sub]; units = 8 and sub = 64.
extern "C" int lstm_scan_bwd_grid_f32(const void* w_frag, const float* valid,
                                      const float* acts, const float* cprev,
                                      const float* dh_out, float* dgates,
                                      void* xch, unsigned* ctr, int D, int T,
                                      int B, int H, int reverse_mask,
                                      int units, int groups, int rows,
                                      int sub, int chunk, int stages,
                                      void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  return launch_grid_f32_bwd(w_frag, valid, acts, cprev, dh_out, dgates, xch,
                             ctr, D, T, B, H, reverse_mask, units, groups,
                             rows, sub, chunk, stages, (cudaStream_t)stream);
}

// Blocks of the backward float32 grid plan one SM holds, and the card's SMs.
extern "C" int lstm_scan_bwd_grid_f32_occupancy(int H, int units, int rows,
                                                int sub, int chunk,
                                                int stages, int* per_sm,
                                                int* sms) {
  if (!lstm::grid_f32_plan_ok(true, H, units, rows, sub, chunk, stages))
    return (int)cudaErrorInvalidValue;
  return (int)lstm::grid_occupancy(
      lstm_bwd_grid_f32_kernel,
      lstm::f32_layout(true, H, rows, chunk, stages).total, per_sm, sms,
      lstm::kF32Threads);
}
