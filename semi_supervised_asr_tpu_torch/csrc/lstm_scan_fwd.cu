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
// Two routes, chosen by shape in ops/lstm_scan.py::cluster_plan and
// passed in as the plan's integers (cluster, rows):
//
// The cluster route (bfloat16, H <= 512).  What bounds the scan on this
// card is the serial chain of each step: the step's h has to reach every
// block that computes a gate column of the next step, then a product of
// R x H x 4H, then the gate math, and only then can the next step start.
// The bytes (0.04 ms at bucket 400) and the products (0.02 ms) are far
// below what T such chains take.  So the design shortens the chain: one
// cluster of C blocks per (direction, tile of R rows); block j owns the
// hidden units [j*u, (j+1)*u), u = H/C, and their 4u gate columns, so the
// gate math stays in the block.  Its slice of w_hh ([H, 4u] bf16, laid out
// by the wrapper in mma fragment order) is copied into shared memory once
// per launch by the bulk-copy engine and read from there for all T steps:
// no weight traffic to L2 in the loop.  The step's product (gate columns as
// mma's M, batch rows as N, h as the k16 x n8 B tiles) runs on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 sums), laid out so that each lane
// ends with all four gates of its (unit, row) pairs in registers: the h and
// c carries live in registers, and the gate math needs no shared memory.
// Each warp then writes its 8 units of its 8 rows of the new h, rounded to
// bf16 (16 bytes a row), into slab j of the next-step h buffer of every
// block of the cluster with st.async (distributed shared memory through
// mapa), each store counted in bytes on the receiving block's mbarrier for
// that buffer; a block starts a step when its barrier has seen the whole
// R x H of it.  (Two stores a lane a step; the backward scan, which sends
// four times as much, sends each block's slab as one bulk copy instead.)  No cluster barrier and
// no release fence sit in the loop: a store is not waited for by its
// sender, and every block waits only for its own inputs.  The h buffers
// alternate by step parity, and a block writes step s+1's h into a peer
// only after it has received that peer's step s h, which the peer sent
// after its step s-1 product had read the buffer: so no rows are
// overwritten while they are read.  Tiles of R = 8 rows (one mma n-tile)
// keep the exchange small (8 x H bf16 a block and step) and the product
// short.  The next step's gates_x and valid values are loaded into
// registers at the start of each step, so their latency hides behind the
// product and the wait; the outputs (h_out and the residuals) are stored
// after the exchange, as whole 32-byte sectors (8 units of a row per warp
// and store).
//
// The CUDA-core route (float32, the exactness checks, and bfloat16 where
// no cluster fits, H > 512): one block owns (direction, tile of kRows
// batch rows) and loops over all T with h and c in shared memory, w_hh
// re-read from L2 every step; 1024 threads each own a 16-byte column group
// over one slice of k, the slices summed in order, then the gate math.

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


// ---- the cluster route (bf16) ----

// the lane's gates_x (4 gates) and valid values of step t for its rows
// rbase + e (zeros past B)
__device__ __forceinline__ void fetch_fwd(const float* __restrict__ gx,
                                          const float* __restrict__ valid,
                                          int t, int B, int H, int row0,
                                          int rbase, int unit,
                                          float (&g)[2][4], float (&v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + rbase + e;
    const bool live = row < B;
    const float* p = gx + ((size_t)t * B + row) * 4 * H + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q) g[e][q] = live ? p[q * H] : 0.f;
    v[e] = live ? valid[(size_t)t * B + row] : 0.f;
  }
}

// One cluster per (direction, tile of R rows), block j = rank in the
// cluster.  Warp (ug, ng) owns the units j*u + 8*ug + [0, 8) and the rows
// 8*ng + [0, 8) of the tile; its A tiles are the two m16 tiles (i | f) and
// (g | o) of its 8 units.  Step s's h is in buffer s & 1 (C slabs of
// [R][u + kPad]); its mbarrier bars[1 + (s & 1)] completes a phase when
// every block's slab of that step has landed.
__global__ void __launch_bounds__(lstm::kClusterThreads)
lstm_fwd_cluster_kernel(const float* __restrict__ gates_x,   // [D,T,B,4H]
                        const __nv_bfloat16* __restrict__ w_frag,  // [D,C,H*4u]
                        const float* __restrict__ valid,     // [T,B]
                        float* __restrict__ h_out,           // [D,T,B,H]
                        float* __restrict__ hprev,           // [D,T,B,H] | NULL
                        float* __restrict__ cprev,           // [D,T,B,H] | NULL
                        float* __restrict__ acts,            // [D,T,B,4H] | NULL
                        int T, int B, int H, int R, int reverse_mask) {
  using namespace lstm;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int C = cluster_size();
  const int j = cluster_rank();
  const int u = H / C, H4 = 4 * H, UG = u / 8, SW = u + kPad;
  const int slab = R * SW;                  // one block's rows of h
  const size_t wbytes = (size_t)H * 4 * u * 2;
  const uint32_t step_bytes = (uint32_t)C * R * u * 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  const uint4* w_s = reinterpret_cast<const uint4*>(smem_b + kHeader);
  __nv_bfloat16* h_s =                      // [2][C][R][SW] h by parity
      reinterpret_cast<__nv_bfloat16*>(smem_b + kHeader + wbytes);
  __nv_bfloat16* own_s = h_s + 2 * C * slab;  // [2][R][SW] this block's

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ug = warp % UG, ng = warp / UG;
  const int d = blockIdx.y;
  const int row0 = (blockIdx.x / C) * R;
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B;
  const float* gx = gates_x + (size_t)d * seq * H4;
  float* ho = h_out + (size_t)d * seq * H;
  const bool residuals = hprev != nullptr;
  const int ul = ug * 8 + (lane >> 2);           // the lane's unit, in block
  const int unit = j * u + ul;
  const int rbase = ng * 8 + 2 * (lane & 3);     // its first row, in tile

  for (int i = threadIdx.x; i < C * slab / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0, 0, 0, 0);   // h = 0
  init_barriers(bars, 3);
  if (threadIdx.x == 0) {        // steps 1 and 2 (buffers 1 and 0)
    if (T > 1) expect_bytes(&bars[2], step_bytes);
    if (T > 2) expect_bytes(&bars[1], step_bytes);
  }
  load_resident(smem_b + kHeader, w_frag + ((size_t)d * C + j) * H * 4 * u,
                (uint32_t)wbytes, &bars[0]);

  float h[2] = {0.f, 0.f}, c[2] = {0.f, 0.f}, gxc[2][4], vc[2];
  fetch_fwd(gx, valid, rev ? T - 1 : 0, B, H, row0, rbase, unit, gxc, vc);
  cluster_sync();     // every block's barriers are set before a remote store

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    float gxn[2][4], vn[2];
    if (s + 1 < T)
      fetch_fwd(gx, valid, rev ? t - 1 : t + 1, B, H, row0, rbase, unit, gxn,
                vn);
    if (s > 0) {        // this step's h has landed in h_s[s & 1]
      wait_phase(&bars[1 + (s & 1)], ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < T)
        expect_bytes(&bars[1 + (s & 1)], step_bytes);
    }

    // gates[4u cols, rows] = w_slice^T . h^T on the tensor cores, k-steps
    // slab by slab (the hidden units of block 0, 1, ...)
    const __nv_bfloat16* hb = h_s + (size_t)(s & 1) * C * slab + ng * 8 * SW;
    const uint4* wp = w_s + (size_t)ug * (H / 16) * 64 + lane;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int jj = 0; jj < C; ++jj, hb += slab)
#pragma unroll 2
      for (int kk = 0; kk < u; kk += 16, wp += 64) {
        uint32_t b0, b1;
        b_frag(hb, SW, kk, b0, b1);
        mma_bf16(acc[0], wp[0], b0, b1);
        mma_bf16(acc[1], wp[32], b0, b1);
      }

    // gate math on the lane's (unit, row) pairs, masked carry update; the
    // outputs wait in registers until the exchange is on its way (out: i,
    // f, g, o, hprev, cprev, h_out)
    float out[2][7];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* o = out[e];
      o[0] = sigmoid(gxc[e][0] + acc[0][e]);
      o[1] = sigmoid(gxc[e][1] + acc[0][2 + e]);
      o[2] = tanhf(gxc[e][2] + acc[1][e]);
      o[3] = sigmoid(gxc[e][3] + acc[1][2 + e]);
      o[4] = h[e];
      o[5] = c[e];
      const float c_new = o[1] * c[e] + o[0] * o[2];
      const float h_new = o[3] * tanhf(c_new);
      const float v = vc[e];
      o[6] = v * h_new;
      h[e] = v * h_new + (1.f - v) * h[e];
      c[e] = v * c_new + (1.f - v) * c[e];
      own_s[((s + 1) & 1) * slab + (rbase + e) * SW + ul] = bf16(h[e]);
    }

    if (s + 1 < T) {
      // the warp's 8 units of its 8 rows (16 bytes a row) into slab j of
      // the next h buffer of every block of the cluster, this one included
      const int nb = (s + 1) & 1;
      send_rows(h_s + ((size_t)nb * C + j) * slab + ng * 8 * SW + ug * 8,
                own_s + nb * slab + ng * 8 * SW + ug * 8, SW, &bars[1 + nb],
                C);
    }

    // the outputs: whole 32-byte sectors (8 units of a row a warp)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + rbase + e;
      if (row >= B) continue;
      const float* o = out[e];
      const size_t off = ((size_t)t * B + row) * H + unit;
      if (residuals) {
        hprev[(size_t)d * seq * H + off] = o[4];
        cprev[(size_t)d * seq * H + off] = o[5];
        float* a = acts + ((size_t)d * seq + (size_t)t * B + row) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q * H] = o[q];
      }
      ho[off] = o[6];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      vc[e] = vn[e];
#pragma unroll
      for (int q = 0; q < 4; ++q) gxc[e][q] = gxn[e][q];
    }
  }
  cluster_sync();       // no block leaves while a peer may still store to it
}

int launch_cluster(const float* gates_x, const void* w_frag,
                   const float* valid, float* h_out, float* hprev,
                   float* cprev, float* acts, int D, int T, int B, int H,
                   int reverse_mask, int C, int R, cudaStream_t stream) {
  const int threads = lstm::fwd_cluster_threads(H, C, R);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = lstm::fwd_cluster_smem(H, C, R);
  dim3 grid(C * ((B + R - 1) / R), D);
  return (int)lstm::launch_clusters(
      lstm_fwd_cluster_kernel, grid, threads, smem, C, stream, gates_x,
      static_cast<const __nv_bfloat16*>(w_frag), valid, h_out, hprev, cprev,
      acts, T, B, H, R, reverse_mask);
}

// The serial chain's floor: T steps of a cluster route's exchange alone
// (no product, no gate math, no global memory), at the shape, threads and
// shared memory of one of its plans and by its protocol: every step each
// block waits for its buffer, then sends its slab of R rows of W bf16 into
// every block's other buffer -- as the forward does (each warp 16 bytes of
// each of its 8 rows by st.async, W = u) or as the backward does (one bulk
// copy of the whole slab a block, W = 4u).
__global__ void __launch_bounds__(lstm::kClusterThreads)
exchange_floor_kernel(int T, int R, int W, int backward) {
  using namespace lstm;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int C = cluster_size();
  const int j = cluster_rank();
  const int SW = W + kPad, slab = R * SW;
  const uint32_t step_bytes = (uint32_t)C * (backward ? slab : R * W) * 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_b + kHeader);
  __nv_bfloat16* own_s = b_s + 2 * C * slab;
  const int warp = threadIdx.x >> 5, ug = warp % (W / 8), ng = warp / (W / 8);
  init_barriers(bars, 3);
  if (threadIdx.x == 0) {
    if (T > 1) expect_bytes(&bars[2], step_bytes);
    if (T > 2) expect_bytes(&bars[1], step_bytes);
  }
  cluster_sync();
  for (int s = 0; s < T; ++s) {
    if (s > 0) {
      wait_phase(&bars[1 + (s & 1)], ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < T)
        expect_bytes(&bars[1 + (s & 1)], step_bytes);
    }
    if (s + 1 < T) {
      const int nb = (s + 1) & 1;
      __nv_bfloat16* dst = b_s + ((size_t)nb * C + j) * slab;
      if (backward)
        send_slab(smem_u32(dst), smem_u32(own_s + nb * slab),
                  (uint32_t)slab * 2, smem_u32(&bars[1 + nb]), C);
      else
        send_rows(dst + ng * 8 * SW + ug * 8,
                  own_s + nb * slab + ng * 8 * SW + ug * 8, SW,
                  &bars[1 + nb], C);
    }
  }
  cluster_sync();
}
}  // namespace

// gates_x [D,T,B,4H] f32, valid [T,B] f32 0/1, h_out [D,T,B,H] f32;
// hprev/cprev [D,T,B,H] and acts [D,T,B,4H] f32 all given or all NULL.
// cluster = 0: the CUDA-core route, w_hh [D,H,4H] (bf16 when w_is_bf16
// else f32).  cluster = C > 0: the cluster route with clusters of C blocks
// and R = rows batch rows; w_hh is bf16 in the wrapper's fragment order
// [D,C,H*4u].  A plan the route cannot take
// returns cudaErrorInvalidValue.  Contiguous, on the stream's device.
extern "C" int lstm_scan_fwd(const float* gates_x, const void* w_hh,
                             const float* valid, float* h_out, float* hprev,
                             float* cprev, float* acts, int D, int T, int B,
                             int H, int reverse_mask, int w_is_bf16,
                             int cluster, int rows, void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 0) {
    if (!w_is_bf16) return (int)cudaErrorInvalidValue;
    return launch_cluster(gates_x, w_hh, valid, h_out, hprev, cprev, acts, D,
                          T, B, H, reverse_mask, cluster, rows, s);
  }
  if (w_is_bf16)
    return launch<__nv_bfloat16>(gates_x, w_hh, valid, h_out, hprev, cprev,
                                 acts, D, T, B, H, reverse_mask, s);
  return launch<float>(gates_x, w_hh, valid, h_out, hprev, cprev, acts, D,
                       T, B, H, reverse_mask, s);
}

// How many clusters of the forward cluster route's plan the card holds at
// once, into *clusters.
extern "C" int lstm_scan_fwd_occupancy(int H, int cluster, int rows,
                                       int* clusters) {
  const int threads = lstm::fwd_cluster_threads(H, cluster, rows);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  return (int)lstm::max_clusters(lstm_fwd_cluster_kernel, threads,
                                 lstm::fwd_cluster_smem(H, cluster, rows),
                                 cluster, clusters);
}

// The exchange floor of a cluster plan (backward = 0: the forward's h
// exchange, u values a row by st.async; 1: the backward's dgates
// exchange, 4u a row by bulk copy) over T steps, launched on the plan's
// grid for D directions and B rows.
extern "C" int lstm_exchange_floor(int backward, int D, int T, int B, int H,
                                   int cluster, int rows, void* stream) {
  const int C = cluster, R = rows;
  const int threads = backward ? lstm::bwd_cluster_threads(H, C, R)
                               : lstm::fwd_cluster_threads(H, C, R);
  if (threads == 0 || T < 1 || B < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = backward ? lstm::bwd_cluster_smem(H, C, R)
                               : lstm::fwd_cluster_smem(H, C, R);
  const int u = H / C;
  dim3 grid(C * ((B + R - 1) / R), D);
  return (int)lstm::launch_clusters(exchange_floor_kernel, grid, threads,
                                    smem, C, (cudaStream_t)stream, T, R,
                                    backward ? 4 * u : u, backward);
}
