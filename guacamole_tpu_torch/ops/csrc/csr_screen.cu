// CSR counting screen and candidate compaction for Hopper (sm_90a).
//
// Built by guacamole_tpu_torch/ops/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes. Every entry point launches
// on the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
//
// Input wire form (guacamole_tpu_torch/ops/dispatch.py::wire_from_numpy):
//   blob     [B]   uint8   two 4-bit allele ids per byte (low nibble first),
//                          0xF = pad; row r owns bytes [row_off[r], row_off[r+1])
//   row_off  [L+1] int32   byte offsets (rebuilt on the device from the uint16
//                          per-row byte counts, or shipped as int32 for rows
//                          over 64 KB)
//   vwords   [L]   uint16  bit k set = allele k of row r is a variant
//
// ---------------------------------------------------------------------------
// csr_count_screen
//
// Replaces guacamole_tpu/ops/pallas_kernels.py::_csr_prefix_kernel (with its
// _lane_cumsum roll scan) and the XLA tail of pallas_csr_screen, which
// differences the K prefix planes at row_off and applies
// guacamole_tpu/ops/kernels.py::counts_candidates. The TPU form built K
// prefix planes over the whole blob and carried a running sum across a
// sequential grid because Mosaic cannot index VMEM dynamically. Here each
// row's byte range is counted directly: one warp per row, grid-stride over
// rows, lanes striding over the row's bytes with up to 15 per-allele
// counters in registers, reduced with __shfl_xor_sync. No prefix planes and
// no intermediate in device memory.
//
// Bound: memory. Each blob byte is read once, plus 4 B of offsets and 2 B of
// variant words per row; each row writes 2K B of int16 counts and 1 B of
// flag. Neighbouring lanes read neighbouring bytes, so a warp's loads
// coalesce. But rows shorter than 32 bytes (most rows at 25x depth) leave
// lanes idle: on an NVIDIA H100 80GB HBM3 at 700 W a 66 MB, 1.1M-row
// megatile takes 0.53 ms, 123 GB/s against the 3.35 TB/s peak. Several
// rows per warp is the first thing to change for speed.
//
// Semantics, bit-equal to the JAX forms: counts are int32 in the kernel and
// narrow to int16 with two's-complement wrap, as JAX's astype does; rows
// deeper than 32767 reads wrap, and the packer flags them as overflow rows
// whose counts are never read. Depth is the row sum of the counts. Nibble
// values >= K (the 0xF pad included) are not counted.
//
// ---------------------------------------------------------------------------
// csr_compact
//
// Replaces the XLA compaction of guacamole_tpu/ops/kernels.py::
// tile_stats_csr_compact (jnp.nonzero(size=cap) + gather). It is a kernel
// here because torch.nonzero synchronises the host on every tile, which
// would serialise the screen pipeline. One block scans the [L] flags in
// chunks of 1024 threads x 8 flags: per-thread count, warp-shuffle scan,
// a second warp scan over the 32 warp totals, then each candidate writes its
// row index and its K counts (widened to int32) at its rank. Output is one
// [cap+1, K+1] int32 array: candidate rows ascending, -1/0 in unused body
// rows, and the true candidate total in [cap, 0] so overflow stays visible.
//
// Bound: latency of one block walking L flags (about 135 chunks for a
// 1.1M-row megatile: 0.28 ms on an NVIDIA H100 80GB HBM3 at 700 W). A
// single block is enough for now; a device-wide decoupled look-back
// scan is the later fix if it shows in a trace.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScreenThreads = 256;  // 8 rows in flight per block
constexpr int kMaxScreenBlocks = 132 * 32;  // 32 blocks per SM of an H100 SXM
constexpr int kCompactThreads = 1024;
constexpr int kCompactItems = 8;

template <int K>
__global__ void csr_count_screen_kernel(const uint8_t* __restrict__ blob,
                                        const int32_t* __restrict__ row_off,
                                        const uint16_t* __restrict__ vwords,
                                        int64_t L, int threshold,
                                        int16_t* __restrict__ counts,
                                        uint8_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // r is uniform across the warp, so every lane reaches the shuffles.
  for (int64_t r = warp; r < L; r += n_warps) {
    const int32_t b0 = row_off[r];
    const int32_t b1 = row_off[r + 1];
    int c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = 0;
    for (int32_t b = b0 + lane; b < b1; b += 32) {
      const int v = blob[b];
      const int lo = v & 0xF;
      const int hi = v >> 4;
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] += (lo == k) + (hi == k);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c[k] += __shfl_xor_sync(kFullMask, c[k], off);
    }
    // Every lane now holds every row total. Lane k stores count k, so the
    // row's 2K bytes go out as one coalesced store.
    int mine = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane == k) mine = c[k];
    if (lane < K)
      counts[r * K + lane] =
          static_cast<int16_t>(static_cast<uint16_t>(mine & 0xFFFF));
    if (lane == 0) {
      int depth = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) depth += c[k];
      const unsigned w = vwords[r];
      bool cand = false;
      int ref_passing = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool var = (w >> k) & 1u;
        if (threshold < 0) {
          cand |= var && c[k] > 0;
        } else {
          // counts_candidates: count * 100 // depth > t, division-free.
          const bool pass = c[k] > 0 && c[k] * 100 >= depth * (threshold + 1);
          cand |= pass && var;
          ref_passing += (pass && !var) ? 1 : 0;
        }
      }
      flags[r] = (cand || ref_passing >= 2) ? 1 : 0;
    }
  }
}

template <int K>
cudaError_t launch_screen(const uint8_t* blob, const int32_t* row_off,
                          const uint16_t* vwords, int64_t L, int threshold,
                          int16_t* counts, uint8_t* flags,
                          cudaStream_t stream) {
  const int64_t rows_per_block = kScreenThreads / 32;
  int64_t blocks = (L + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxScreenBlocks) blocks = kMaxScreenBlocks;
  csr_count_screen_kernel<K><<<static_cast<unsigned>(blocks), kScreenThreads,
                               0, stream>>>(blob, row_off, vwords, L,
                                            threshold, counts, flags);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kCompactThreads)
    csr_compact_kernel(const uint8_t* __restrict__ flags,
                       const int16_t* __restrict__ counts, int64_t L, int K,
                       int cap, int32_t* __restrict__ out) {
  __shared__ int warp_totals[kCompactThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int width = K + 1;
  int base = 0;  // candidates before this chunk; uniform across the block
  for (int64_t c0 = 0; c0 < L;
       c0 += static_cast<int64_t>(kCompactThreads) * kCompactItems) {
    const int64_t i0 = c0 + static_cast<int64_t>(t) * kCompactItems;
    bool f[kCompactItems];
    int n = 0;
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      f[j] = (i0 + j < L) && flags[i0 + j] != 0;
      n += f[j] ? 1 : 0;
    }
    int x = n;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_totals[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int s = warp_totals[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFullMask, s, off);
        if (lane >= off) s += y;
      }
      warp_totals[lane] = s;
    }
    __syncthreads();
    int rank = base + (wid ? warp_totals[wid - 1] : 0) + x - n;
    const int chunk_total = warp_totals[kCompactThreads / 32 - 1];
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      if (f[j]) {
        if (rank < cap) {
          const int64_t row = i0 + j;
          int32_t* dst = out + static_cast<int64_t>(rank) * width;
          dst[0] = static_cast<int32_t>(row);
          for (int k = 0; k < K; ++k) dst[1 + k] = counts[row * K + k];
        }
        ++rank;
      }
    }
    base += chunk_total;
    __syncthreads();  // warp_totals is rewritten by the next chunk
  }
  const int used = base < cap ? base : cap;
  const int64_t body_end = static_cast<int64_t>(cap) * width;
  for (int64_t e = static_cast<int64_t>(used) * width + t; e < body_end;
       e += kCompactThreads)
    out[e] = (e % width == 0) ? -1 : 0;
  for (int e = t; e < width; e += kCompactThreads)
    out[body_end + e] = e == 0 ? base : 0;
}

}  // namespace

extern "C" {

// counts [L, K] int16 and flags [L] uint8 (0/1, a torch.bool tensor) are
// written for every row. threshold < 0 means "no threshold": a row is a
// candidate when any variant allele has reads.
int guac_csr_count_screen(const void* blob, const void* row_off,
                          const void* vwords, int64_t L, int K, int threshold,
                          void* counts, void* flags, void* stream) {
  const auto* b = static_cast<const uint8_t*>(blob);
  const auto* o = static_cast<const int32_t*>(row_off);
  const auto* w = static_cast<const uint16_t*>(vwords);
  auto* c = static_cast<int16_t*>(counts);
  auto* f = static_cast<uint8_t*>(flags);
  auto s = static_cast<cudaStream_t>(stream);
  if (L <= 0) return static_cast<int>(cudaGetLastError());  // empty grid
  switch (K) {
#define GUAC_SCREEN_CASE(k) \
  case k:                   \
    return static_cast<int>(launch_screen<k>(b, o, w, L, threshold, c, f, s));
    GUAC_SCREEN_CASE(1)
    GUAC_SCREEN_CASE(2)
    GUAC_SCREEN_CASE(3)
    GUAC_SCREEN_CASE(4)
    GUAC_SCREEN_CASE(5)
    GUAC_SCREEN_CASE(6)
    GUAC_SCREEN_CASE(7)
    GUAC_SCREEN_CASE(8)
    GUAC_SCREEN_CASE(9)
    GUAC_SCREEN_CASE(10)
    GUAC_SCREEN_CASE(11)
    GUAC_SCREEN_CASE(12)
    GUAC_SCREEN_CASE(13)
    GUAC_SCREEN_CASE(14)
    GUAC_SCREEN_CASE(15)
#undef GUAC_SCREEN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [cap+1, K+1] int32 is written in full.
int guac_csr_compact(const void* flags, const void* counts, int64_t L, int K,
                     int cap, void* out, void* stream) {
  if (K < 1 || K > 15 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  csr_compact_kernel<<<1, kCompactThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), static_cast<const int16_t*>(counts),
      L, K, cap, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
