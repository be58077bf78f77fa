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
// at the same time index as h_out, for the backward scan.  Optional initial
// carries h0, c0 ([D,B,H] f32; NULL: zeros) resume a scan where an earlier
// one stopped, and h_fin, c_fin ([D,B,H] f32; NULL: not written) receive
// the carries after the last step -- each row's state after its last valid
// step, since invalid steps pass the carry through (chunked streaming).
// With h0 NULL every route computes exactly what it computed without them.
//
// Three routes, chosen by shape in ops/lstm_scan.py::cluster_plan and
// passed in as the plan's integers:
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
// The grid route (bfloat16, H > 512; ops/lstm_scan.py::grid_plan).  w_hh
// fits no cluster there (4.7 MB a direction at H=768 against 16 x 227 KB)
// but fits the card: N = H/u blocks for each (direction, group of R batch
// rows), all resident at once (a cooperative launch, refused before it
// starts when the card cannot hold the grid), each holding its slice of
// w_hh ([H, 4u], u = 16 at H=768) in shared memory for the whole scan, in
// the cluster route's fragment order.  The serial chain still bounds a
// step, and h now reaches the other blocks through L2: each block writes
// its u units of h_{s+1} (bf16) into a global buffer chosen by step parity
// and arrives on its row group's counter; a block waits until the counter
// shows all N arrivals, streams the group's rows of h_s through a ring of
// shared-memory stages by cp.async, multiplies them on mma.sync (a warp a
// work unit of 8 units x 8 rows; the k-steps split among warps where there
// are fewer than 8, the parts added in a fixed order), runs the gate math
// and writes h_{s+1}.  As many row groups as fit the card keep the rows a
// block reads a step few (H=768, D=1, B=64: 2 groups of 32 rows, 96
// blocks).  The next step's gates_x and valid are copied in before the
// wait; the outputs are stored after the arrival.
//
// The CUDA-core route (float32, the exactness checks, and bfloat16 where
// neither fits): one block owns (direction, tile of kRows batch rows) and
// loops over all T with h and c in shared memory, w_hh re-read from L2
// every step; 1024 threads each own a 16-byte column group over one slice
// of k, the slices summed in order, then the gate math.

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
                     const float* __restrict__ h0,        // [D,B,H] | NULL
                     const float* __restrict__ c0,        // [D,B,H] | NULL
                     float* __restrict__ h_fin,           // [D,B,H] | NULL
                     float* __restrict__ c_fin,           // [D,B,H] | NULL
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
    float h = 0.f, c = 0.f;
    if (h0 != nullptr && i / H < nrows) {
      const size_t o = ((size_t)d * B + row0) * H + i;
      h = h0[o];
      c = c0[o];
    }
    h_s[i] = h;
    c_s[i] = c;
    hq_s[i] = WVec<W>::round(h);
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
  if (h_fin != nullptr)
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const size_t o = ((size_t)d * B + row0) * H + i;
      h_fin[o] = h_s[i];
      c_fin[o] = c_s[i];
    }
}

template <typename W>
int launch(const float* gates_x, const void* w_hh, const float* valid,
           float* h_out, float* hprev, float* cprev, float* acts,
           const float* h0, const float* c0, float* h_fin, float* c_fin,
           int D, int T, int B, int H, int reverse_mask,
           cudaStream_t stream) {
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
      acts, h0, c0, h_fin, c_fin, T, B, H, reverse_mask);
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
                        const float* __restrict__ h0,        // [D,B,H] | NULL
                        const float* __restrict__ c0,        // [D,B,H] | NULL
                        float* __restrict__ h_fin,           // [D,B,H] | NULL
                        float* __restrict__ c_fin,           // [D,B,H] | NULL
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

  if (h0 == nullptr) {
    for (int i = threadIdx.x; i < C * slab / 8; i += blockDim.x)
      reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0, 0, 0, 0);   // h = 0
  } else {
    // step 0's h: every block's slab of round(h0), zeros past B and in the
    // pad columns
    for (int i = threadIdx.x; i < C * slab; i += blockDim.x) {
      const int jj = i / slab, r = (i % slab) / SW, col = i % SW;
      const int row = row0 + r;
      h_s[i] = bf16(col < u && row < B
                        ? h0[((size_t)d * B + row) * H + jj * u + col]
                        : 0.f);
    }
  }
  init_barriers(bars, 3);
  if (threadIdx.x == 0) {        // steps 1 and 2 (buffers 1 and 0)
    if (T > 1) expect_bytes(&bars[2], step_bytes);
    if (T > 2) expect_bytes(&bars[1], step_bytes);
  }
  load_resident(smem_b + kHeader, w_frag + ((size_t)d * C + j) * H * 4 * u,
                (uint32_t)wbytes, &bars[0]);

  float h[2] = {0.f, 0.f}, c[2] = {0.f, 0.f}, gxc[2][4], vc[2];
  if (h0 != nullptr)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + rbase + e;
      if (row < B) {
        h[e] = h0[((size_t)d * B + row) * H + unit];
        c[e] = c0[((size_t)d * B + row) * H + unit];
      }
    }
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
  if (h_fin != nullptr)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + rbase + e;
      if (row < B) {
        h_fin[((size_t)d * B + row) * H + unit] = h[e];
        c_fin[((size_t)d * B + row) * H + unit] = c[e];
      }
    }
  cluster_sync();       // no block leaves while a peer may still store to it
}

int launch_cluster(const float* gates_x, const void* w_frag,
                   const float* valid, float* h_out, float* hprev,
                   float* cprev, float* acts, const float* h0,
                   const float* c0, float* h_fin, float* c_fin, int D, int T,
                   int B, int H, int reverse_mask, int C, int R,
                   cudaStream_t stream) {
  const int threads = lstm::fwd_cluster_threads(H, C, R);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = lstm::fwd_cluster_smem(H, C, R);
  dim3 grid(C * ((B + R - 1) / R), D);
  return (int)lstm::launch_clusters(
      lstm_fwd_cluster_kernel, grid, threads, smem, C, stream, gates_x,
      static_cast<const __nv_bfloat16*>(w_frag), valid, h_out, hprev, cprev,
      acts, h0, c0, h_fin, c_fin, T, B, H, R, reverse_mask);
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


// ---- the grid route (bf16, H > 512) ----

// One block per (unit slice j, row group g, direction d): grid (N, G, D).
// Warp w takes work unit w % W (8 units ug x 8 rows nt of the sub-tile:
// its two A tiles (i | f) and (g | o), as in the cluster route) and the
// k-steps kk with kk % ksplit == w / W (ksplit = 8 / W).  Lane pairs: unit
// 8*ug + lane/4, rows 8*nt + 2*(lane%4) + e.  Step s reads h_s from
// exchange buffer s & 1 (h_0 = 0: no product at s = 0, unless h0 is given:
// then the wrapper has written round(h0) into buffer 0 before the launch)
// and writes h_{s+1}
// into buffer (s+1) & 1 before arriving on the counter: a block writes
// buffer (s+1) & 1 only after the count of step s, i.e. after every
// block's step-s arrival, which each made after its step s-1 product had
// read that buffer.
__global__ void __launch_bounds__(lstm::kGridThreads, 1)
lstm_fwd_grid_kernel(const float* __restrict__ gates_x,   // [D,T,B,4H]
                     const __nv_bfloat16* __restrict__ w_frag,  // [D,N,H*4u]
                     const float* __restrict__ valid,     // [T,B]
                     float* __restrict__ h_out,           // [D,T,B,H]
                     float* __restrict__ hprev,           // [D,T,B,H] | NULL
                     float* __restrict__ cprev,           // [D,T,B,H] | NULL
                     float* __restrict__ acts,            // [D,T,B,4H] | NULL
                     const float* __restrict__ h0,        // [D,B,H] | NULL
                     const float* __restrict__ c0,        // [D,B,H] | NULL
                     float* __restrict__ h_fin,           // [D,B,H] | NULL
                     float* __restrict__ c_fin,           // [D,B,H] | NULL
                     __nv_bfloat16* __restrict__ xch,     // [2,D,G*R,H]
                     unsigned* __restrict__ ctr,          // [D*G], zeroed
                     int T, int B, int H, int R, int RS, int KC, int S,
                     int reverse_mask) {
  using namespace lstm;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int N = gridDim.x, G = gridDim.y, D = gridDim.z;
  const int j = blockIdx.x, g = blockIdx.y, d = blockIdx.z;
  const int u = H / N, H4 = 4 * H, UG = u / 8;
  const int W = UG * (RS / 8), ksplit = kGridWarps / W;
  const int KSC = KC / 16, SW = KC + kPad;
  const GridLayout L = grid_layout(false, H, u, R, RS, KC, S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_b);
  const uint4* w_s = reinterpret_cast<const uint4*>(smem_b + kGridHeader);
  __nv_bfloat16* ring_s = reinterpret_cast<__nv_bfloat16*>(smem_b + L.ring);
  float* gx_s = reinterpret_cast<float*>(smem_b + L.in);    // [RS][4u]
  float* v_s = gx_s + RS * 4 * u;                            // [RS]
  float* h_s = reinterpret_cast<float*>(smem_b + L.carry);  // [R][u]
  float* c_s = h_s + R * u;                                  // [R][u]
  float* part_s = reinterpret_cast<float*>(smem_b + L.part);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wu = warp % W, kp = warp / W;
  const int ug = wu % UG, nt = wu / UG;
  const bool rev = (reverse_mask >> d) & 1;
  const size_t seq = (size_t)T * B, xrows = (size_t)G * R;
  const float* gx = gates_x + (size_t)d * seq * H4;
  float* ho = h_out + (size_t)d * seq * H;
  const bool residuals = hprev != nullptr;
  unsigned* my_ctr = ctr + d * G + g;
  const int ul = ug * 8 + (lane >> 2);            // the lane's unit, in block
  const int unit = j * u + ul;

  // the lane's outputs of a sub-tile at step t (pairs e: rows r0 + 8*nt +
  // 2*(lane%4) + e): whole 32-byte sectors, 8 units of a row a warp
  float out[2][7];
  auto store = [&](int t, int r0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + nt * 8 + 2 * (lane & 3) + e;
      if (row >= B) continue;
      const float* o = out[e];
      const size_t off = ((size_t)t * B + row) * H + unit;
      if (residuals) {
        hprev[(size_t)d * seq * H + off] = o[4];
        cprev[(size_t)d * seq * H + off] = o[5];
        float* ac = acts + ((size_t)d * seq + (size_t)t * B + row) * H4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) ac[q * H] = o[q];
      }
      ho[off] = o[6];
    }
  };

  if (h0 == nullptr) {
    for (int i = threadIdx.x; i < 2 * R * u; i += blockDim.x) h_s[i] = 0.f;
  } else {
    for (int i = threadIdx.x; i < R * u; i += blockDim.x) {
      const int row = g * R + i / u;
      const size_t o = ((size_t)d * B + row) * H + j * u + i % u;
      h_s[i] = row < B ? h0[o] : 0.f;
      c_s[i] = row < B ? c0[o] : 0.f;
    }
  }
  init_barriers(bars, 1);
  load_resident(smem_b + kGridHeader, w_frag + ((size_t)d * N + j) * H * 4 * u,
                (uint32_t)((size_t)H * 4 * u * 2), &bars[0]);

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    for (int r0 = g * R; r0 < g * R + R; r0 += RS) {
      // this step's gates_x of the sub-tile's rows (4 gate groups of u
      // units) and valid, in flight while the block waits and multiplies
      for (int i = threadIdx.x; i < RS * u; i += blockDim.x) {
        const int r = i / u, p = i - r * u, q = p / (u / 4), k = p % (u / 4);
        const int row = r0 + r;
        const bool live = row < B;
        cp16(gx_s + r * 4 * u + q * u + 4 * k,
             gx + ((size_t)t * B + (live ? row : 0)) * H4 + q * H + j * u +
                 4 * k,
             live);
      }
      for (int r = threadIdx.x; r < RS; r += blockDim.x)
        cp4(v_s + r, valid + (size_t)t * B + (r0 + r < B ? r0 + r : 0),
            r0 + r < B);
      cp_commit();

      // gates[4u cols, rows] = w_slice^T . round(h_s)^T, two accumulator
      // chains a tile (alternate k-steps), added in a fixed order
      float acc[2][2][4] = {};
      if (s > 0 || h0 != nullptr) {
        if (s > 0 && r0 == g * R) grid_wait(my_ctr, (unsigned)N * s);
        ring(ring_s, xch + (((size_t)(s & 1) * D + d) * xrows + r0) * H, RS,
             H, KC, S, [&](int c, const __nv_bfloat16* stage) {
               const __nv_bfloat16* hb = stage + nt * 8 * SW;
               const uint4* wp = w_s + ((size_t)ug * (H / 16) +
                                        (size_t)c * KSC) * 64 + lane;
               auto step = [&](int kk, float(&a0)[4], float(&a1)[4]) {
                 uint32_t b0, b1;
                 b_frag(hb, SW, kk * 16, b0, b1);
                 mma_bf16(a0, wp[kk * 64], b0, b1);
                 mma_bf16(a1, wp[kk * 64 + 32], b0, b1);
               };
               int kk = kp;
#pragma unroll 2
               for (; kk + ksplit < KSC; kk += 2 * ksplit) {
                 step(kk, acc[0][0], acc[1][0]);
                 step(kk + ksplit, acc[0][1], acc[1][1]);
               }
               if (kk < KSC) step(kk, acc[0][0], acc[1][0]);
             });
      }
      float sum[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[m][q] = acc[m][0][q] + acc[m][1][q];
      if (kp > 0) {
        float* p = part_s + (((size_t)(kp - 1) * W + wu) * 32 + lane) * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) p[q] = sum[q / 4][q % 4];
      }
      cp_wait<0>();
      __syncthreads();

      if (kp == 0) {
        for (int k = 1; k < ksplit; ++k) {
          const float* p = part_s + (((size_t)(k - 1) * W + wu) * 32 + lane) * 8;
#pragma unroll
          for (int q = 0; q < 8; ++q) sum[q / 4][q % 4] += p[q];
        }
        // gate math on the lane's (unit, row) pairs, masked carry update,
        // h_{s+1} into the exchange; the outputs (i, f, g, o, hprev,
        // cprev, h_out) wait in registers
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = nt * 8 + 2 * (lane & 3) + e;
          const float* gq = gx_s + rr * 4 * u + ul;
          float* o = out[e];
          o[0] = sigmoid(gq[0] + sum[0][e]);
          o[1] = sigmoid(gq[u] + sum[0][2 + e]);
          o[2] = tanhf(gq[2 * u] + sum[1][e]);
          o[3] = sigmoid(gq[3 * u] + sum[1][2 + e]);
          float* hc = h_s + (r0 - g * R + rr) * u + ul;
          float* cc = c_s + (r0 - g * R + rr) * u + ul;
          o[4] = *hc;
          o[5] = *cc;
          const float c_new = o[1] * o[5] + o[0] * o[2];
          const float h_new = o[3] * tanhf(c_new);
          const float v = v_s[rr];
          const float h2 = v * h_new + (1.f - v) * o[4];
          o[6] = v * h_new;
          *hc = h2;
          *cc = v * c_new + (1.f - v) * o[5];
          if (s + 1 < T)
            xch[(((size_t)((s + 1) & 1) * D + d) * xrows + r0 + rr) * H +
                unit] = bf16(h2);
        }
        // a sub-tile's outputs go out once the next one needs the
        // registers; the last one's after the arrival
        if (r0 + RS < g * R + R) store(t, r0);
      }
      __syncthreads();   // the ring, inputs and partials are free again
    }
    if (s + 1 < T) grid_arrive(my_ctr);
    if (kp == 0) store(t, g * R + R - RS);
  }
  if (h_fin != nullptr)      // the carries are final since the last sync
    for (int i = threadIdx.x; i < R * u; i += blockDim.x) {
      const int row = g * R + i / u;
      if (row >= B) continue;
      const size_t o = ((size_t)d * B + row) * H + j * u + i % u;
      h_fin[o] = h_s[i];
      c_fin[o] = c_s[i];
    }
}

int launch_grid_fwd(const float* gates_x, const void* w_frag,
                    const float* valid, float* h_out, float* hprev,
                    float* cprev, float* acts, const float* h0,
                    const float* c0, float* h_fin, float* c_fin, void* xch,
                    unsigned* ctr,
                    int D, int T, int B, int H, int reverse_mask, int u,
                    int G, int R, int RS, int KC, int S,
                    cudaStream_t stream) {
  if (!lstm::grid_plan_ok(false, H, u, R, RS, KC, S) || G < 1 ||
      (long long)G * R < B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lstm::grid_layout(false, H, u, R, RS, KC, S).total;
  return (int)lstm::launch_grid(
      lstm_fwd_grid_kernel, dim3(H / u, G, D), smem, stream, gates_x,
      static_cast<const __nv_bfloat16*>(w_frag), valid, h_out, hprev, cprev,
      acts, h0, c0, h_fin, c_fin, static_cast<__nv_bfloat16*>(xch), ctr, T,
      B, H, R, RS, KC, S, reverse_mask);
}

// The grid route's serial floor: T steps of its protocol alone, on the
// grid, threads and shared memory of one of its plans -- every block
// publishes its W bf16 values of each of its group's R rows into the next
// buffer and arrives; then (read = 1) it waits and streams the step's rows
// through the ring in sub-tiles of RS, as the scans do, or (read = 0) only
// waits.  No product, no gate math, no other global memory.
__global__ void __launch_bounds__(lstm::kGridThreads, 1)
grid_floor_kernel(__nv_bfloat16* __restrict__ xch, unsigned* __restrict__ ctr,
                  int T, int K, int W, int R, int RS, int KC, int S,
                  int read) {
  using namespace lstm;
  extern __shared__ __align__(16) uint8_t smem_b[];
  const int N = gridDim.x, G = gridDim.y, D = gridDim.z;
  const int j = blockIdx.x, g = blockIdx.y, d = blockIdx.z;
  __nv_bfloat16* ring_s =
      reinterpret_cast<__nv_bfloat16*>(smem_b + kGridHeader);
  const size_t xrows = (size_t)G * R;
  unsigned* my_ctr = ctr + d * G + g;
  for (int s = 0; s < T; ++s) {
    for (int r0 = g * R; r0 < g * R + R; r0 += RS) {
      if (s > 0 && r0 == g * R) grid_wait(my_ctr, (unsigned)N * s);
      if (s > 0 && read)
        ring(ring_s, xch + (((size_t)(s & 1) * D + d) * xrows + r0) * K, RS,
             K, KC, S, [](int, const __nv_bfloat16*) {});
      cp_wait<0>();
      __syncthreads();
      if (s + 1 < T)
        for (int i = threadIdx.x; i < RS * W; i += blockDim.x)
          xch[(((size_t)((s + 1) & 1) * D + d) * xrows + r0 + i / W) * K +
              j * W + i % W] = bf16(0.f);
      __syncthreads();
    }
    if (s + 1 < T) grid_arrive(my_ctr);
  }
}
}  // namespace

// gates_x [D,T,B,4H] f32, valid [T,B] f32 0/1, h_out [D,T,B,H] f32;
// hprev/cprev [D,T,B,H] and acts [D,T,B,4H] f32 all given or all NULL;
// h0/c0 [D,B,H] f32 both given (the initial carries) or both NULL (zeros);
// h_fin/c_fin [D,B,H] f32 both given (the final carries) or both NULL.
// (The grid route has its own entry, lstm_scan_fwd_grid.)
// cluster = 0: the CUDA-core route, w_hh [D,H,4H] (bf16 when w_is_bf16
// else f32).  cluster = C > 0: the cluster route with clusters of C blocks
// and R = rows batch rows; w_hh is bf16 in the wrapper's fragment order
// [D,C,H*4u].  A plan the route cannot take
// returns cudaErrorInvalidValue.  Contiguous, on the stream's device.
extern "C" int lstm_scan_fwd(const float* gates_x, const void* w_hh,
                             const float* valid, float* h_out, float* hprev,
                             float* cprev, float* acts, const float* h0,
                             const float* c0, float* h_fin, float* c_fin,
                             int D, int T, int B, int H, int reverse_mask,
                             int w_is_bf16, int cluster, int rows,
                             void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  if ((h0 == nullptr) != (c0 == nullptr) ||
      (h_fin == nullptr) != (c_fin == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster > 0) {
    if (!w_is_bf16) return (int)cudaErrorInvalidValue;
    return launch_cluster(gates_x, w_hh, valid, h_out, hprev, cprev, acts, h0,
                          c0, h_fin, c_fin, D, T, B, H, reverse_mask, cluster,
                          rows, s);
  }
  if (w_is_bf16)
    return launch<__nv_bfloat16>(gates_x, w_hh, valid, h_out, hprev, cprev,
                                 acts, h0, c0, h_fin, c_fin, D, T, B, H,
                                 reverse_mask, s);
  return launch<float>(gates_x, w_hh, valid, h_out, hprev, cprev, acts, h0,
                       c0, h_fin, c_fin, D, T, B, H, reverse_mask, s);
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

// The grid route (bf16, H > 512): gates_x, valid, h_out, the residuals and
// the carries as lstm_scan_fwd (with h0 given, buffer 0 of xch must hold
// round(h0) in rows [0, B) and zeros in the rest, as the wrapper writes it);
// w_frag bf16 w_hh in the fragment order of H/units
// pieces [D, H/units, H*4*units]; xch bf16 scratch [2, D, groups*rows, H];
// ctr [D*groups] u32, zeroed.  The plan's integers: units u a block,
// groups G of rows batch rows, sub-tiles of sub rows, ring chunks of chunk
// columns in stages stages.  A plan the route cannot take returns
// cudaErrorInvalidValue, a grid the card cannot hold all at once
// cudaErrorCooperativeLaunchTooLarge, both before any launch.
extern "C" int lstm_scan_fwd_grid(const float* gates_x, const void* w_frag,
                                  const float* valid, float* h_out,
                                  float* hprev, float* cprev, float* acts,
                                  const float* h0, const float* c0,
                                  float* h_fin, float* c_fin, void* xch,
                                  unsigned* ctr, int D, int T, int B, int H,
                                  int reverse_mask, int units, int groups,
                                  int rows, int sub, int chunk, int stages,
                                  void* stream) {
  if (D == 0 || T == 0 || B == 0) return 0;
  if ((h0 == nullptr) != (c0 == nullptr) ||
      (h_fin == nullptr) != (c_fin == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_grid_fwd(gates_x, w_frag, valid, h_out, hprev, cprev, acts,
                         h0, c0, h_fin, c_fin, xch, ctr, D, T, B, H,
                         reverse_mask, units, groups, rows, sub, chunk,
                         stages, (cudaStream_t)stream);
}

// Blocks of the forward grid plan one SM holds, and the card's SMs: the
// plan's N*G*D blocks must fit in their product.
extern "C" int lstm_scan_fwd_grid_occupancy(int H, int units, int rows,
                                            int sub, int chunk, int stages,
                                            int* per_sm, int* sms) {
  if (!lstm::grid_plan_ok(false, H, units, rows, sub, chunk, stages))
    return (int)cudaErrorInvalidValue;
  return (int)lstm::grid_occupancy(
      lstm_fwd_grid_kernel,
      lstm::grid_layout(false, H, units, rows, sub, chunk, stages).total,
      per_sm, sms);
}

// The grid route's serial floor over T steps (backward = 0: K2's plan,
// the h exchange of u values a row and block; 1: K3's, 4u values), on the
// plan's grid and shared memory for D directions and B rows; read = 0
// leaves out the step's read of the exchange (the barrier alone).
extern "C" int lstm_grid_floor(int backward, int read, int D, int T, int B,
                               int H, int units, int groups, int rows,
                               int sub, int chunk, int stages, void* xch,
                               unsigned* ctr, void* stream) {
  const bool bwd = backward != 0;
  if (!lstm::grid_plan_ok(bwd, H, units, rows, sub, chunk, stages) ||
      groups < 1 || (long long)groups * rows < B || T < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      lstm::grid_layout(bwd, H, units, rows, sub, chunk, stages).total;
  return (int)lstm::launch_grid(
      grid_floor_kernel, dim3(H / units, groups, D), smem,
      (cudaStream_t)stream, static_cast<__nv_bfloat16*>(xch), ctr, T,
      bwd ? 4 * H : H, bwd ? 4 * units : units, rows, sub, chunk, stages,
      read);
}
