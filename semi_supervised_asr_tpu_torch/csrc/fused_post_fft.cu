// Fused post-FFT audio frontend for NVIDIA Hopper (sm_90a).
//
// Replaces: semi_supervised_asr_tpu/ops/pallas_frontend.py::_kernel (the
// Pallas TPU kernel reached through fused_post_fft).
//
// Computes, per row (utterance b, frame t) of the [B*T, F] power spectrum,
// all float32:
//   mel[m] = sum_f pspec[b,t,f] * fb[f,m]          (Slaney mel bank)
//   y      = (log(max(mel, log_floor)) - mean[m]) * inv_std[m]
//   out    = 0 where t >= lens[b], or where m lies in one of the
//            utterance's SpecAugment frequency bands [fs, fs+fw), or t in
//            one of its time bands [ts, ts+tw); y elsewhere.
//
// What bounds it on this card: HBM.  The input is read once (257 floats a
// row) and the output written once (80 floats a row), ~1.3 KB a row: 17 MB
// for a batch of 32 x 400 frames, ~5 us at 3.35 TB/s, against 13 MFLOP of
// sums.  So the CUDA cores do the sums and the tensor cores stay out: the
// work is far below the card's operations-per-byte line, and TF32 would
// break the 1e-5 agreement with the plain version.  The mel bank is
// triangular -- filter m is non-zero only on a short run of FFT bins
// [lo_m, hi_m) -- so the caller passes each filter's run packed (band_w,
// band_lo, band_off) and the kernel sums only over it, with fmaf in bin
// order: skipped terms are exact zeros, so for finite inputs the sum
// equals the dense in-order sum bit for bit.
//
// The design keeps HBM streaming while the SMs compute:
// - Tiles of R rows over the flattened [B*T, F] rows, R a multiple of 4:
//   4 rows are 16*F bytes, so every tile is one contiguous chunk whose
//   start and size are multiples of 16 bytes, fetched whole by one bulk
//   copy (cp.async.bulk, global -> shared) that completes on an mbarrier.
//   Only the last tile can end off a 16-byte boundary: its 16-byte prefix
//   comes by bulk copy, its last floats by plain loads.  A tile may span
//   utterances: each row finds its own as row / T.
// - A persistent grid (blocks_per_sm x the SM count, at most one block a
//   tile) whose blocks walk the tiles with a stride, through a ring of S
//   stages: one producer warp keeps the next tiles' copies in flight while
//   the consumer warps compute the current one.  The producer also turns
//   each row's length and SpecAugment bands into one 128-bit keep mask
//   (zero where the frame is padding or in a time band; the utterance's
//   frequency bands cleared), so no band parameter is read per output.
// - Consumer thread (m, g) owns filter m in rows g, g+G, g+2G, ... of
//   every tile (G row groups, I = R/G rows).  Its filter's run, weights'
//   offset and CMVN constants stay in registers for the whole kernel, and
//   each weight, read once a tile, feeds I independent sums; the log, the
//   CMVN and the mask, which cost more than the sums, run once an output.
//   Threads are numbered filter-major, so a warp holds 32/G neighbouring
//   filters, whose runs (2-18 bins, growing with m) are nearly equal: a
//   lane seldom waits for a longer run in its warp.  A warp's spectrum
//   reads and feature writes spread over the banks (a row of the spectrum
//   is an odd number of floats; at most 2-way on the writes), and a
//   weight is one broadcast.
//   (Lanes over rows, with a warp's loop over its filters, ran slower: the
//   filter's setup and the log then cost a whole warp per output.)
// - The features go to a ring of 3 staging tiles and leave by one bulk
//   store per tile (R*M floats, 16-byte aligned when M % 4 == 0).
// - The dynamic shared memory limit is set once per process, not per call.
// Any B and T are accepted (no lane padding as on the TPU).  The band
// parameters are sampled by the caller, as the TPU kernel takes them
// through scalar prefetch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxMels = 128;    // a row's keep mask is 4 words
constexpr int kMaxGroups = 4;    // row groups G
constexpr int kMaxThreads = kMaxMels * kMaxGroups + 32;
constexpr int kOutBufs = 3;      // staging ring of the bulk stores
constexpr int kMaxSmem = 232448;  // per block, sm_90

// consumer threads: one a (filter, row group), in whole warps
__host__ __device__ inline int consumers(int M, int G) {
  return (M * G + 31) / 32 * 32;
}

// byte offsets of the shared-memory regions; the last entry is the total
struct Layout {
  int full, empty, x, keep, y, w, total;
};

__host__ __device__ inline Layout layout(int R, int S, int F, int M,
                                         int nnz) {
  Layout l;
  l.full = 0;
  l.empty = 8 * S;
  l.x = 16 * S;                                  // 16-byte aligned
  l.keep = l.x + S * R * F * 4;                  // R % 4 == 0: aligned
  l.y = l.keep + S * R * 16;
  l.w = l.y + kOutBufs * R * M * 4;
  l.total = l.w + nnz * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase of this parity.  A phase
// that never completes is a fault: after ~4e9 cycles (~2 s) the kernel
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completion is counted on `bar` in transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) from shared `src` to global `dst`, one bulk
// group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
// the consumer warps alone (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// bits [lo, hi) of a 32-bit word, lo and hi clamped to [0, 32]
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = min(max(lo, 0), 32);
  hi = min(max(hi, 0), 32);
  return hi > lo ? (uint32_t)((1ull << hi) - (1ull << lo)) : 0u;
}

__device__ __forceinline__ uint32_t word(const uint4& k, int i) {
  return i == 0 ? k.x : i == 1 ? k.y : i == 2 ? k.z : k.w;
}

struct Params {
  const float* pspec;    // [rows, F]
  const float* band_w;   // [nnz]
  const int* band_lo;    // [M]
  const int* band_off;   // [M + 1]
  const float* mean;     // [M]
  const float* inv_std;  // [M]
  const int* lens;       // [B]
  const int* fs;         // [B, n_freq]
  const int* fw;
  const int* ts;         // [B, n_time]
  const int* tw;
  float* out;            // [rows, M]
  long long rows;        // B * T
  int T, F, M, nnz, n_freq, n_time;
  float log_floor;
};

// bit m of the result is 1 where out[row, m] keeps its value
__device__ uint4 row_keep(const Params& p, long long row) {
  const int b = (int)(row / p.T);
  const int t = (int)(row - (long long)b * p.T);
  bool keep = t < p.lens[b];
  for (int i = 0; i < p.n_time; ++i) {
    const int s = p.ts[b * p.n_time + i];
    keep = keep && !(t >= s && t < s + p.tw[b * p.n_time + i]);
  }
  uint32_t k[4] = {0u, 0u, 0u, 0u};
  if (keep) {
    for (int j = 0; j < 4; ++j) k[j] = bit_range(0, p.M - 32 * j);
    for (int i = 0; i < p.n_freq; ++i) {
      const int s = p.fs[b * p.n_freq + i];
      const int e = s + p.fw[b * p.n_freq + i];
      for (int j = 0; j < 4; ++j) k[j] &= ~bit_range(s - 32 * j, e - 32 * j);
    }
  }
  return make_uint4(k[0], k[1], k[2], k[3]);
}

// I rows a consumer thread owns in a tile: R = I * G
template <int I>
__global__ void __launch_bounds__(kMaxThreads)
fused_post_fft_kernel(const Params p, const int G, const int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int R = I * G;
  const Layout l = layout(R, S, p.F, p.M, p.nnz);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + l.empty);
  float* x_s = reinterpret_cast<float*>(smem + l.x);       // [S][R][F]
  uint4* keep_s = reinterpret_cast<uint4*>(smem + l.keep);  // [S][R]
  float* y_s = reinterpret_cast<float*>(smem + l.y);       // [3][R][M]
  float* w_s = reinterpret_cast<float*>(smem + l.w);       // [nnz]

  const int n_cons = consumers(p.M, G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_tiles = (int)((p.rows + R - 1) / R);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);            // the copy's lane + 32 lanes
      mbar_init(&empty[s], n_cons / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= n_cons) {
    // ---- producer warp: bulk copies, tail loads and keep masks ----
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int s = it % S;
      if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
      const long long row0 = (long long)tile * R;
      const int rows = (int)min((long long)R, p.rows - row0);
      const int n = rows * p.F;
      const uint32_t bulk = (uint32_t)(n * 4) & ~15u;
      float* dst = x_s + s * R * p.F;
      const float* src = p.pspec + row0 * p.F;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], bulk);
        if (bulk) bulk_load(dst, src, bulk, &full[s]);
      }
      for (int i = bulk / 4 + lane; i < n; i += 32) dst[i] = src[i];
      if (lane < rows) keep_s[s * R + lane] = row_keep(p, row0 + lane);
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warps: thread (m, g), filter-major ----
  for (int i = tid; i < p.nnz; i += n_cons) w_s[i] = p.band_w[i];
  const int m_raw = tid / G;
  const int g = tid - m_raw * G;
  const bool active = m_raw < p.M;
  const int m = active ? m_raw : 0;
  const int lo = p.band_lo[m], off = p.band_off[m];
  const int n = active ? p.band_off[m + 1] - off : 0;
  const float mean = p.mean[m], istd = p.inv_std[m];
  const int stride = G * p.F;                // between a thread's rows
  consumer_sync(n_cons);

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int s = it % S;
    const long long row0 = (long long)tile * R;
    const int rows = (int)min((long long)R, p.rows - row0);
    mbar_wait(&full[s], (it / S) & 1);

    bool kept[I];
    float acc[I];
#pragma unroll
    for (int j = 0; j < I; ++j) {
      const uint4 k = keep_s[s * R + g + G * j];
      kept[j] = (word(k, m >> 5) >> (m & 31)) & 1u;
      acc[j] = 0.f;
    }
    const float* x = x_s + (s * R + g) * p.F + lo;
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      const float w = w_s[off + k];
#pragma unroll
      for (int j = 0; j < I; ++j) acc[j] = fmaf(x[j * stride + k], w, acc[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // the stage may be refilled

    float* y = y_s + (it % kOutBufs) * R * p.M;
    if (active) {
#pragma unroll
      for (int j = 0; j < I; ++j) {
        const int r = g + G * j;
        if (r < rows) {
          const float v = (logf(fmaxf(acc[j], p.log_floor)) - mean) * istd;
          y[r * p.M + m] = kept[j] ? v : 0.f;
        }
      }
    }
    // the staging tile is read by the async proxy next
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync(n_cons);
    if (tid == 0) {
      bulk_store(p.out + row0 * p.M, y, (uint32_t)(rows * p.M * 4));
      // at most this tile's store still reads its buffer: the buffer the
      // consumers write next (two tiles old) is free before they pass the
      // next consumer_sync
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

template <int I>
int launch(const Params& p, int G, int S, int blocks_per_sm,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_post_fft_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int R = I * G;
  const int smem = layout(R, S, p.F, p.M, p.nnz).total;
  const int sms = sm_count();
  if (smem > kMaxSmem || sms == 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (p.rows + R - 1) / R;
  const long long most = (long long)blocks_per_sm * sms;
  const int grid = (int)(tiles < most ? tiles : most);
  fused_post_fft_kernel<I>
      <<<grid, consumers(p.M, G) + 32, smem, stream>>>(p, G, S);
  return (int)cudaGetLastError();
}

}  // namespace

// pspec [B,T,F] f32; the mel bank [F,M] packed by filter: band_w [nnz]
// f32 holds fb[band_lo[m] + k, m] at band_off[m] + k, band_off [M+1] i32
// (band_off[M] = nnz), band_lo [M] i32; mean/inv_std [M] f32; lens [B]
// i32; fs/fw [B,n_freq], ts/tw [B,n_time] i32 (NULL when the count is 0);
// out [B,T,M] f32.  All contiguous, on the device of `stream`; pspec and
// out 16-byte aligned; M a multiple of 4, at most 128.  The launch plan:
// `rows` per tile (8, 16 or 32) in `groups` row groups (2 or 4, at most
// 8 rows a group), `stages` in the ring (>= 1), `blocks_per_sm` (>= 1)
// blocks per SM in the persistent grid.
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
                              int rows, int groups, int stages,
                              int blocks_per_sm, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (M % 4 != 0 || M > kMaxMels || stages < 1 || blocks_per_sm < 1 ||
      (rows != 8 && rows != 16 && rows != 32) ||
      (groups != 2 && groups != 4) || rows / groups > 8 ||
      reinterpret_cast<uintptr_t>(pspec) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{pspec, band_w, band_lo, band_off, mean, inv_std, lens,
                 fs, fw, ts, tw, out, (long long)B * T, T, F, M, nnz,
                 n_freq, n_time, log_floor};
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows / groups) {
    case 2: return launch<2>(p, groups, stages, blocks_per_sm, st);
    case 4: return launch<4>(p, groups, stages, blocks_per_sm, st);
    default: return launch<8>(p, groups, stages, blocks_per_sm, st);
  }
}
