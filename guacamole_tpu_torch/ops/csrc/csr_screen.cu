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
// row's byte range is counted directly. No prefix planes and no
// intermediate in device memory.
//
// Bound: memory. Each blob byte is read once, plus 4 B of offsets and 2 B of
// variant words per row; each row writes 2K B of int16 counts and 1 B of
// flag.
//
// Design. Stage, then count; warps do not wait for one another.
//  - A warp owns 32 consecutive rows, whose bytes are one contiguous span
//    [row_off[r0], row_off[r1]) of the blob. It brings the span into its
//    own part of shared memory in chunks of 2,560 bytes with 16-byte
//    cp.async copies (every lane a 16-byte piece, neighbouring lanes
//    neighbouring pieces), two chunks in flight: chunk i + 1 loads while
//    chunk i is counted, and only __syncwarp() stands between them. (A
//    first version staged 8 KB chunks per block of 256 rows behind
//    __syncthreads(); on the card it took 0.094 ms at the megatile where
//    this layout, otherwise the same, took 0.084 ms.) The
//    span is aligned down to 16 bytes by ADDRESS, so a blob that starts at
//    any byte (a slice of a tensor) is taken; a piece that is not wholly
//    inside [blob, blob + B) is copied byte by byte, so nothing outside the
//    blob is read, padded or not.
//  - Work per thread follows the row's length. Lane t owns row r0 + t and
//    keeps its K totals in registers. Of the part of its row that lies in
//    the chunk, the lane itself counts the first and the last 16-byte piece
//    (they hold bytes of other rows, which it sets to the 0xFF pad first)
//    and, when the part is at most 64 bytes (depth <= 128: all but the hot
//    spots), the pieces between: no shuffle at all. Where the last piece's
//    bytes sit below the first piece's (always so for a part of up to 16
//    bytes) the two are ANDed into one piece and counted once, since a
//    count does not care where a nibble lies. The pieces between the ends
//    of a longer part are counted by the whole warp, 16 bytes a lane, with
//    no masking, and the warp's sums go to the owner with one
//    __reduce_add_sync per allele. A row longer than a chunk (up to the
//    64 KB+ rows of the int32-offset form) is simply met in several chunks.
//  - 16 bytes are counted at once: a 4x4 bit transpose turns the four
//    words into four planes P0..P3, where bit 4n + j of P_i is bit i of
//    nibble n of word j; nibble == k is then an AND of the four planes,
//    each straight or complemented, over all 32 nibbles, and the count one
//    __popc into a plain int counter (no packed fields, so nothing to
//    flush). ops/edge_shapes.py holds a numpy model of this arithmetic.
//  - The rule where the counts are: the owner lane applies
//    counts_candidates to its K totals.
//  - Coalesced output: the warp's int16 counts meet in shared memory and
//    leave as 16-byte stores over one contiguous range; its 32 flags leave
//    as eight 4-byte words, built from one ballot.
// What holds it now is integer throughput, not memory: of the megatile's 0.067
// ms on an NVIDIA H100 80GB HBM3 at 700 W, leaving the cp.async copies out
// saves 8%, the warps' pieces 31%, the lanes' own pieces 24%; the rest is
// per-row work: offsets, the rule, the output (chip_tune.py --no-check;
// PERF.md).
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
// would serialise the screen pipeline. Output is one [cap+1, K+1] int32
// array: candidate rows ascending with their K counts (widened to int32),
// -1/0 in unused body rows, and the true candidate total in [cap, 0] so
// overflow stays visible.
//
// Bound: latency. The data is tiny (one byte a row in, a few thousand
// candidate rows out), so what counts is how many dependent steps stand
// between the launch and the last store, and a launch itself.
//
// Design: a stream compaction across the whole device, reduce-then-scan in
// two launches back to back on the caller's stream.
//  - Pass A. The flags are cut into chunks, one a block: 256 threads x 32
//    flags (two 16-byte loads a thread), more whole tiles of that size once
//    the tile would give more than 1,024 blocks. A block counts the flags
//    set in its chunk (a popcount per thread, one warp reduction) and writes
//    the count to its place in 1,024 ints of scratch from the wrapper.
//  - Pass B, the same grid. Every block adds up the block totals itself (at
//    most four a thread), which gives it the candidates before its chunk
//    and the total. It reads its chunk again, now in the L2 cache, ranks its
//    candidates (a bit mask of 32 flags per thread, a shuffle scan inside
//    the warp, the warp totals through shared memory, one barrier a tile)
//    and writes row index and counts of those that rank below cap. Since
//    every block knows the total, the unused body rows [min(total, cap),
//    cap) are filled by all blocks in shares, with 16-byte stores, and
//    block 0 writes the footer. Candidate rows lie below min(total, cap)
//    and fill rows at or above it, so no two blocks write one word.
//  - No atomics, no state that must be zeroed between launches, the same
//    output whatever the order of the blocks, and nothing shared between
//    calls but the scratch, which the wrapper allocates per call.
//  - Up to 32,768 flags one block of 1,024 threads does all of it in one
//    launch (the same code with no block totals): a second launch would cost
//    more than the walk. That route also serves L = 0.
//  - The flags may start at any byte of a larger tensor: positions count
//    from their address aligned down to 16 bytes, a thread's 32 flags that
//    are not all inside [flags, flags + L) are read byte by byte, and no
//    byte outside is read. ops/edge_shapes.py holds a numpy model of the
//    partition.
// ---------------------------------------------------------------------------

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScreenThreads = 128;   // one row per thread
constexpr int kScreenWarps = kScreenThreads / 32;
constexpr int kChunkBytes = 2560;     // one of a warp's two staging buffers
constexpr int kThreadRowBytes = 64;   // a longer part takes the whole warp
constexpr int kCompactThreads = 256;     // a block of the two-pass route
constexpr int kOneBlockThreads = 1024;   // the block of the one-block route
constexpr int kFlagsPerThread = 32;      // two 16-byte loads
constexpr int kCompactMaxBlocks = 1024;  // a block sums all block totals itself
constexpr int kOneBlockFlags = 32768;    // up to here: one block, one launch

// The bytes of w lie at a .. a+3: those outside [lo, hi) become the 0xFF pad.
__device__ __forceinline__ uint32_t pad_outside(uint32_t w, int a, int lo,
                                                int hi) {
  const int head = lo - a;  // bytes to drop at the low end
  const int keep = hi - a;  // bytes below the high cut
  if (head > 0) w |= head >= 4 ? 0xFFFFFFFFu : (1u << (8 * head)) - 1u;
  if (keep < 4) w |= keep <= 0 ? 0xFFFFFFFFu : 0xFFFFFFFFu << (8 * keep);
  return w;
}

// w moved so that bit i of every nibble lands on bit j of the same nibble.
__device__ __forceinline__ uint32_t nibble_bit(uint32_t w, int i, int j) {
  return (i >= j ? w >> (i - j) : w << (j - i)) & (0x11111111u << j);
}

// The 16 bytes q lie at a .. a+15: those outside [lo, hi) become the pad.
__device__ __forceinline__ uint4 pad_outside16(uint4 q, int a, int lo,
                                               int hi) {
  q.x = pad_outside(q.x, a, lo, hi);
  q.y = pad_outside(q.y, a + 4, lo, hi);
  q.z = pad_outside(q.z, a + 8, lo, hi);
  q.w = pad_outside(q.w, a + 12, lo, hi);
  return q;
}

// Adds to c[k] the nibbles equal to k among the 16 bytes q.
template <int K>
__device__ __forceinline__ void count16(uint4 q, int (&c)[K]) {
  // Bit 4n + j of plane[i] is bit i of nibble n of word j.
  uint32_t plane[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    plane[i] = nibble_bit(q.x, i, 0) | nibble_bit(q.y, i, 1) |
               nibble_bit(q.z, i, 2) | nibble_bit(q.w, i, 3);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t equal = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 0; i < 4; ++i) equal &= ((k >> i) & 1) ? plane[i] : ~plane[i];
    c[k] += __popc(equal);
  }
}

template <int K>
__global__ void __launch_bounds__(kScreenThreads)
    csr_count_screen_kernel(const uint8_t* __restrict__ blob, int64_t n_blob,
                            const int32_t* __restrict__ row_off,
                            const uint16_t* __restrict__ vwords, int64_t L,
                            int threshold, int16_t* __restrict__ counts,
                            uint8_t* __restrict__ flags) {
  __shared__ __align__(16) uint8_t stage_all[kScreenWarps][2][kChunkBytes];
  __shared__ __align__(16) int16_t out_all[kScreenWarps][32 * K];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  // Warps do not wait for one another: each owns 32 rows, its two staging
  // buffers and its slice of the output.
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kScreenWarps + wid) * 32;
  if (r0 >= L) return;
  uint8_t(*stage)[kChunkBytes] = stage_all[wid];
  int16_t* out_counts = out_all[wid];
  const int64_t row = r0 + lane;
  const bool has_row = row < L;
  const int rows_here = static_cast<int>(L - r0 < 32 ? L - r0 : 32);
  // Offsets from here on count from the blob's address aligned down to 16
  // bytes, so that every 16-byte piece is aligned whatever the blob's first
  // byte is; the blob itself is [mis, mis + n_blob) there.
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(blob) & 15u);
  const uint8_t* base = blob - mis;
  const int64_t blob_end = n_blob + mis;
  int64_t b0 = 0, b1 = 0;
  if (has_row) {
    b0 = static_cast<int64_t>(row_off[row]) + mis;
    b1 = static_cast<int64_t>(row_off[row + 1]) + mis;
  }
  // The warp's span, and this lane's row, relative to the span's origin.
  const int64_t origin =
      __shfl_sync(kFullMask, b0, 0) & ~static_cast<int64_t>(15);
  const int span_bytes =
      static_cast<int>(__shfl_sync(kFullMask, b1, rows_here - 1) - origin);
  const int my_lo = has_row ? static_cast<int>(b0 - origin) : 0;
  const int my_hi = has_row ? static_cast<int>(b1 - origin) : 0;
  const int n_chunks = (span_bytes + kChunkBytes - 1) / kChunkBytes;

  auto stage_chunk = [&](int i) {
    uint8_t* dst = stage[i & 1];
    for (int p = lane * 16; p < kChunkBytes; p += 32 * 16) {
      const int at = i * kChunkBytes + p;
      if (at >= span_bytes) break;
      const int64_t v = origin + at;
      if (v >= mis && v + 16 <= blob_end) {
        __pipeline_memcpy_async(dst + p, base + v, 16);
      } else {  // the blob's first or last piece: only bytes inside it
        for (int j = 0; j < 16; ++j)
          if (v + j >= mis && v + j < blob_end) dst[p + j] = base[v + j];
      }
    }
    __pipeline_commit();
  };

  int c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0;
  if (n_chunks > 0) stage_chunk(0);
  // n_chunks is uniform across the warp, so every lane reaches the
  // __syncwarp()s and the votes.
  for (int i = 0; i < n_chunks; ++i) {
    if (i + 1 < n_chunks) {
      stage_chunk(i + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const uint8_t* buf = stage[i & 1];
    const int cs = i * kChunkBytes;
    const int lo = my_lo > cs ? my_lo : cs;
    const int hi = my_hi < cs + kChunkBytes ? my_hi : cs + kChunkBytes;
    const int n = hi - lo;  // this row's bytes inside the chunk
    // The lane's own work: the first and the last 16-byte piece of its part
    // (they hold bytes of other rows, which become the pad), and, when the
    // part is short, the pieces between. Where the last piece's bytes sit
    // below the first piece's (always, for a part of up to 16 bytes), the
    // two are merged and counted as one: a count does not care where in the
    // 16 bytes a nibble lies.
    if (n > 0) {
      const int first = lo & ~15;
      const int last = (hi - 1) & ~15;
      uint4 q = pad_outside16(
          *reinterpret_cast<const uint4*>(buf + (first - cs)), first, lo, hi);
      if (last != first) {
        const uint4 r = pad_outside16(
            *reinterpret_cast<const uint4*>(buf + (last - cs)), last, lo, hi);
        if (((hi - 1) & 15) < (lo & 15)) {
          q.x &= r.x;
          q.y &= r.y;
          q.z &= r.z;
          q.w &= r.w;
        } else {
          count16<K>(r, c);
        }
      }
      count16<K>(q, c);
      if (n <= kThreadRowBytes)
        for (int a = first + 16; a < last; a += 16)
          count16<K>(*reinterpret_cast<const uint4*>(buf + (a - cs)), c);
    }
    // The pieces between the first and the last of a long part: the warp,
    // 16 bytes a lane, no byte of another row among them.
    unsigned todo = __ballot_sync(kFullMask, n > kThreadRowBytes);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int wlo = (__shfl_sync(kFullMask, lo, src) & ~15) + 16;
      const int whi = (__shfl_sync(kFullMask, hi, src) - 1) & ~15;
      int part[K];
#pragma unroll
      for (int k = 0; k < K; ++k) part[k] = 0;
      for (int a = wlo + lane * 16; a < whi; a += 32 * 16)
        count16<K>(*reinterpret_cast<const uint4*>(buf + (a - cs)), part);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int total = __reduce_add_sync(kFullMask, part[k]);
        if (lane == src) c[k] += total;
      }
    }
    __syncwarp();  // stage[i & 1] is refilled for chunk i + 2
  }

  // The rule where the counts are.
  bool flag = false;
  if (has_row) {
    int depth = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) depth += c[k];
    const unsigned w = vwords[row];
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
    flag = cand || ref_passing >= 2;
  }
  // The warp's 32 flags leave as eight words of four 0/1 bytes.
  const unsigned votes = __ballot_sync(kFullMask, flag);
  if (lane < 8) {
    const int64_t fr = r0 + lane * 4;
    const unsigned bits = (votes >> (4 * lane)) & 0xFu;
    const uint32_t word = (bits & 1u) | ((bits & 2u) << 7) |
                          ((bits & 4u) << 14) | ((bits & 8u) << 21);
    if (fr + 4 <= L && (reinterpret_cast<uintptr_t>(flags) & 3u) == 0) {
      *reinterpret_cast<uint32_t*>(flags + fr) = word;
    } else {
      for (int j = 0; j < 4; ++j)
        if (fr + j < L) flags[fr + j] = (word >> (8 * j)) & 0xFFu;
    }
  }
  // The warp's counts are one contiguous range of the output.
#pragma unroll
  for (int k = 0; k < K; ++k)
    out_counts[lane * K + k] =
        static_cast<int16_t>(static_cast<uint16_t>(c[k] & 0xFFFF));
  __syncwarp();
  int16_t* dst = counts + r0 * K;
  const int n_values = rows_here * K;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    const int n16 = n_values / 8;
    for (int p = lane; p < n16; p += 32)
      reinterpret_cast<uint4*>(dst)[p] =
          reinterpret_cast<const uint4*>(out_counts)[p];
    done = n16 * 8;
  }
  for (int e = done + lane; e < n_values; e += 32) dst[e] = out_counts[e];
}

template <int K>
cudaError_t launch_screen(const uint8_t* blob, int64_t n_blob,
                          const int32_t* row_off, const uint16_t* vwords,
                          int64_t L, int threshold, int16_t* counts,
                          uint8_t* flags, cudaStream_t stream) {
  const int64_t blocks = (L + kScreenThreads - 1) / kScreenThreads;
  csr_count_screen_kernel<K><<<static_cast<unsigned>(blocks), kScreenThreads,
                               0, stream>>>(blob, n_blob, row_off, vwords, L,
                                            threshold, counts, flags);
  return cudaGetLastError();
}

// The bytes of w that are not 0, as bits 0..3.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  // Bit 7 of every byte that is not 0, moved down to bits 0, 8, 16, 24; the
  // product then gathers them in bits 24..27 (no two terms meet, so nothing
  // carries).
  const uint32_t h = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((h >> 7) * 0x01020408u) >> 24;
}

// The 32 flags at positions v .. v + 31 as a bit mask, bit j for v + j.
// Positions count from `base`, the flags' address aligned down to 16 bytes,
// and v is a multiple of 32, so both loads are aligned. The flags themselves
// are [lo, hi): a position outside gives 0 and is not read.
__device__ __forceinline__ uint32_t flag_mask32(const uint8_t* __restrict__ base,
                                                int64_t v, int64_t lo,
                                                int64_t hi) {
  if (v >= hi || v + kFlagsPerThread <= lo) return 0;
  uint32_t m = 0;
  if (v >= lo && v + kFlagsPerThread <= hi) {
    const uint4 a = *reinterpret_cast<const uint4*>(base + v);
    const uint4 b = *reinterpret_cast<const uint4*>(base + v + 16);
    m = nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 |
        nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
        nonzero_bytes(b.x) << 16 | nonzero_bytes(b.y) << 20 |
        nonzero_bytes(b.z) << 24 | nonzero_bytes(b.w) << 28;
  } else {  // the head or the tail of the flags
    for (int j = 0; j < kFlagsPerThread; ++j)
      if (v + j >= lo && v + j < hi && base[v + j] != 0) m |= 1u << j;
  }
  return m;
}

// Pass A of the two-pass route: block b counts the flags set in its chunk
// [b * chunk, (b + 1) * chunk) and writes the count to block_total[b].
__global__ void __launch_bounds__(kCompactThreads)
    compact_count_kernel(const uint8_t* __restrict__ base, int64_t lo,
                         int64_t hi, int64_t chunk,
                         int32_t* __restrict__ block_total) {
  __shared__ int warp_sum[kCompactThreads / 32];
  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  int n = 0;
  for (int64_t v = c0 + t * kFlagsPerThread; v < c0 + chunk && v < hi;
       v += kCompactThreads * kFlagsPerThread)
    n += __popc(flag_mask32(base, v, lo, hi));
  n = __reduce_add_sync(kFullMask, n);
  if ((t & 31) == 0) warp_sum[t >> 5] = n;
  __syncthreads();
  if (t == 0) {
    int total = 0;
    for (int w = 0; w < kCompactThreads / 32; ++w) total += warp_sum[w];
    block_total[blockIdx.x] = total;
  }
}

// Pass B, and the whole of the one-block route (block_total == nullptr, a
// grid of one block whose chunk is all flags). A block learns the candidates
// before its chunk and the total from block_total, ranks the candidates of
// its chunk tile by tile (kThreads x 32 flags), writes those below cap, and
// takes its share of the unused body rows; block 0 writes the footer.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    compact_scatter_kernel(const uint8_t* __restrict__ base, int64_t lo,
                           int64_t hi, int64_t chunk,
                           const int16_t* __restrict__ counts, int K, int cap,
                           const int32_t* __restrict__ block_total,
                           int32_t* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_sum[2][kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int width = K + 1;
  int before = 0;   // candidates in the chunks before this one
  int total = 0;    // candidates in all chunks
  if (block_total != nullptr) {
    int mine_before = 0, mine_all = 0;
    for (int i = t; i < static_cast<int>(gridDim.x); i += kThreads) {
      const int x = block_total[i];
      mine_all += x;
      if (i < static_cast<int>(blockIdx.x)) mine_before += x;
    }
    mine_before = __reduce_add_sync(kFullMask, mine_before);
    mine_all = __reduce_add_sync(kFullMask, mine_all);
    if (lane == 0) {
      warp_sum[0][wid] = mine_before;
      warp_sum[1][wid] = mine_all;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      before += warp_sum[0][w];
      total += warp_sum[1][w];
    }
    __syncthreads();  // warp_sum is rewritten by the tiles
  }
  // Every bound of this loop is the same for all threads of the block. With
  // the total known, a chunk whose candidates all rank at or above cap is
  // not read again.
  int rank0 = before;  // candidates before the tile
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  int parity = 0;
  for (int64_t v0 = c0; v0 < c0 + chunk && v0 < hi;
       v0 += kThreads * kFlagsPerThread) {
    if (block_total != nullptr && rank0 >= cap) break;
    const int64_t v = v0 + t * kFlagsPerThread;
    uint32_t m = flag_mask32(base, v, lo, hi);
    const int n = __popc(m);
    int x = n;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[parity][wid] = x;
    // One barrier a tile: the next tile writes the other half of warp_sum,
    // and no thread reaches the tile after that before all have read this.
    __syncthreads();
    int warps_before = 0, tile_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[parity][w];
      if (w < wid) warps_before += s;
      tile_total += s;
    }
    int rank = rank0 + warps_before + x - n;
    while (m != 0 && rank < cap) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int64_t row = v + j - lo;
      int32_t* dst = out + static_cast<int64_t>(rank) * width;
      dst[0] = static_cast<int32_t>(row);
      for (int k = 0; k < K; ++k) dst[1 + k] = counts[row * K + k];
      ++rank;
    }
    rank0 += tile_total;
    parity ^= 1;
  }
  if (block_total == nullptr) total = rank0;
  // The unused body rows [used, cap): -1 in column 0, zeros beside it. All
  // blocks share them, in groups of four elements (out is aligned to 16
  // bytes): group g holds elements 4g .. 4g + 3.
  const int used = total < cap ? total : cap;
  const int64_t e_lo = static_cast<int64_t>(used) * width;
  const int64_t e_hi = static_cast<int64_t>(cap) * width;
  const int64_t g_hi = (e_hi + 3) >> 2;
  for (int64_t g =
           (e_lo >> 2) + static_cast<int64_t>(blockIdx.x) * kThreads + t;
       g < g_hi; g += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t e = 4 * g;
    // Element e lies in column e mod width; 32-bit division where it will
    // do, since this loop is all a small tile's one block has to do.
    const unsigned r = e_hi < (int64_t{1} << 31)
                           ? static_cast<unsigned>(e) %
                                 static_cast<unsigned>(width)
                           : static_cast<unsigned>(e % width);
    int4 q;
    q.x = r == 0 ? -1 : 0;
    q.y = (r + 1) % width == 0 ? -1 : 0;
    q.z = (r + 2) % width == 0 ? -1 : 0;
    q.w = (r + 3) % width == 0 ? -1 : 0;
    if (e >= e_lo && e + 4 <= e_hi) {
      *reinterpret_cast<int4*>(out + e) = q;
    } else {
      if (e >= e_lo && e < e_hi) out[e] = q.x;
      if (e + 1 >= e_lo && e + 1 < e_hi) out[e + 1] = q.y;
      if (e + 2 >= e_lo && e + 2 < e_hi) out[e + 2] = q.z;
      if (e + 3 >= e_lo && e + 3 < e_hi) out[e + 3] = q.w;
    }
  }
  if (blockIdx.x == 0)
    for (int e = t; e < width; e += kThreads) out[e_hi + e] = e == 0 ? total : 0;
}

}  // namespace

extern "C" {

// counts [L, K] int16 and flags [L] uint8 (0/1, a torch.bool tensor) are
// written for every row. threshold < 0 means "no threshold": a row is a
// candidate when any variant allele has reads. n_blob is the blob's length
// in bytes (below 2^31 - 16): no byte outside [blob, blob + n_blob) is read.
int guac_csr_count_screen(const void* blob, int64_t n_blob,
                          const void* row_off, const void* vwords, int64_t L,
                          int K, int threshold, void* counts, void* flags,
                          void* stream) {
  const auto* b = static_cast<const uint8_t*>(blob);
  const auto* o = static_cast<const int32_t*>(row_off);
  const auto* w = static_cast<const uint16_t*>(vwords);
  auto* c = static_cast<int16_t*>(counts);
  auto* f = static_cast<uint8_t*>(flags);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_blob < 0 || n_blob >= (int64_t{1} << 31) - 16 ||
      L >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) return static_cast<int>(cudaGetLastError());  // empty grid
  switch (K) {
#define GUAC_SCREEN_CASE(k) \
  case k:                   \
    return static_cast<int>(         \
        launch_screen<k>(b, n_blob, o, w, L, threshold, c, f, s));
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

// out [cap+1, K+1] int32, aligned to 16 bytes, is written in full. flags [L]
// uint8 may start at any
// byte; no byte outside [flags, flags + L) is read. scratch: room for 1024
// int32 (the block totals of the two-pass route), written and read by this
// call's launches only, so calls on several streams need one each.
int guac_csr_compact(const void* flags, const void* counts, int64_t L, int K,
                     int cap, void* out, void* stream, void* scratch) {
  if (K < 1 || K > 15 || cap < 0 || L < 0 || L >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int16_t*>(counts);
  auto* o = static_cast<int32_t*>(out);
  // Positions count from the flags' address aligned down to 16 bytes, where
  // the flags are [lo, hi): every 16-byte load is aligned whatever the first
  // byte is, and chunks begin at multiples of a tile.
  const int64_t lo =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(flags) & 15u);
  const int64_t hi = lo + L;
  const uint8_t* base = static_cast<const uint8_t*>(flags) - lo;
  if (L <= kOneBlockFlags) {
    // A grid of one block also serves L == 0: the fill and the footer.
    compact_scatter_kernel<kOneBlockThreads><<<1, kOneBlockThreads, 0, s>>>(
        base, lo, hi, hi > 0 ? hi : 1, c, K, cap, nullptr, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // One tile (256 threads x 32 flags) a block while that gives at most 1024
  // blocks; beyond, whole tiles more, so the count of blocks stays there.
  constexpr int64_t kTile = int64_t{kCompactThreads} * kFlagsPerThread;
  const int64_t tiles = (hi + kTile - 1) / kTile;
  const int64_t chunk =
      (tiles + kCompactMaxBlocks - 1) / kCompactMaxBlocks * kTile;
  const unsigned blocks = static_cast<unsigned>((hi + chunk - 1) / chunk);
  auto* totals = static_cast<int32_t*>(scratch);
  compact_count_kernel<<<blocks, kCompactThreads, 0, s>>>(base, lo, hi, chunk,
                                                          totals);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  compact_scatter_kernel<kCompactThreads><<<blocks, kCompactThreads, 0, s>>>(
      base, lo, hi, chunk, c, K, cap, totals, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
