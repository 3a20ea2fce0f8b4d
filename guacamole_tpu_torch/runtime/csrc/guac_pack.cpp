// guac_pack: native tile packer.
//
// Takes the (filtered) columnar read arrays plus a tile's loci and emits
// the dense [L, D] pileup tensors (the LocusTile fields) in one pass —
// the C++ counterpart of guacamole_tpu_torch/pack/columnar.py + the shared
// tile-assembly stage in pack/fast.py (cross-checked in
// tests/test_pack_columnar.py / test_runtime.py).
//
// The locus axis is processed in contiguous blocks by a small thread pool:
// each block owns its rows, so the [L, D] fills and the per-locus allele
// tables race-free-parallelize; only the rare long-allele-key interning
// (indels) takes a mutex. The tile can also be L-padded here (l_pad) so
// callers get fixed-shape tensors without a post-hoc Python copy.
//
// Compiled into libguac_runtime.so together with guac_runtime.cpp.

#include <algorithm>
#include <array>
#include <chrono>
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <type_traits>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

enum { EV_BASE = 0, EV_INSERTION, EV_DELETION, EV_MID_DELETION, EV_CLIPPED };

// Allocator that default-initializes (i.e. leaves trivial types
// uninitialized) on vector resize. The [L, D] tile tensors are written
// exactly once by the parallel fill passes below — value-initializing
// them first would serially memset hundreds of MB per call, which
// dominated the packer's runtime.
template <typename T, typename A = std::allocator<T>>
struct default_init_allocator : public A {
  template <typename U>
  struct rebind {
    using other = default_init_allocator<
        U, typename std::allocator_traits<A>::template rebind_alloc<U>>;
  };
  using A::A;
  template <typename U>
  void construct(U* ptr) noexcept(
      std::is_nothrow_default_constructible<U>::value) {
    ::new (static_cast<void*>(ptr)) U;
  }
  template <typename U, typename... Args>
  void construct(U* ptr, Args&&... args) {
    std::allocator_traits<A>::construct(static_cast<A&>(*this), ptr,
                                        std::forward<Args>(args)...);
  }
};

template <typename T>
using raw_vector = std::vector<T, default_init_allocator<T>>;

struct AlleleKey {
  std::string ref;
  std::string alt;
  bool operator<(const AlleleKey& o) const {
    if (ref != o.ref) return ref < o.ref;
    return alt < o.alt;
  }
  bool operator==(const AlleleKey& o) const {
    return ref == o.ref && alt == o.alt;
  }
};

// Zero-allocation decoded view of an element code (see the code scheme at
// the elem_code declaration), for ordering codes by allele (ref, alt)
// byte order without materializing AlleleKey strings. buf must hold 2
// bytes and outlive the view (short codes decode into it).
struct KeyView {
  const char* ref;
  int32_t rlen;
  const char* alt;
  int32_t alen;
};

static inline KeyView code_view(int32_t code,
                                const std::vector<AlleleKey>& long_keys,
                                char* buf) {
  int32_t tag = code & 0x70000;
  if (tag == 0x10000) {
    buf[0] = (char)((code >> 8) & 0xff);
    buf[1] = (char)(code & 0xff);
    return {buf, 1, buf + 1, 1};
  }
  if (tag == 0x20000) {
    buf[0] = (char)(code & 0xff);
    return {buf, 1, buf, 0};
  }
  if (tag == 0x30000) return {buf, 0, buf, 0};
  const AlleleKey& k = long_keys[(size_t)(code - 0x40000)];
  return {k.ref.data(), (int32_t)k.ref.size(), k.alt.data(),
          (int32_t)k.alt.size()};
}

// Same ordering as AlleleKey::operator< (std::string compares bytes as
// unsigned, like memcmp).
static inline bool view_less(const KeyView& a, const KeyView& b) {
  int c = memcmp(a.ref, b.ref, (size_t)std::min(a.rlen, b.rlen));
  if (c) return c < 0;
  if (a.rlen != b.rlen) return a.rlen < b.rlen;
  c = memcmp(a.alt, b.alt, (size_t)std::min(a.alen, b.alen));
  if (c) return c < 0;
  return a.alen < b.alen;
}

struct PackedTile {
  int64_t L = 0, D = 0, K = 0;
  // [L]
  std::vector<uint8_t> ref_base;
  raw_vector<int32_t> depth;
  std::vector<int16_t> num_alleles;
  std::vector<uint8_t> overflow;
  // [L, D] (uninitialized-alloc; every cell written by the fill passes)
  raw_vector<int16_t> allele_id;
  raw_vector<int16_t> qual;
  raw_vector<int16_t> mapq;
  raw_vector<uint8_t> strand;
  raw_vector<int16_t> mismatches;
  raw_vector<int32_t> edge;
  raw_vector<int32_t> read_index;
  raw_vector<uint8_t> valid;
  // [L, ceil(D/2)] two 4-bit allele ids per byte, 0xF = empty slot — the
  // device transfer encoding for the counting screen (ops/dispatch.py).
  raw_vector<uint8_t> packed_nib;
  // Screen-mode CSR encoding: row r's elements occupy csr_nib bytes
  // [csr_off[r], csr_off[r+1]) — two 4-bit allele ids per byte, rows
  // byte-aligned (odd-depth rows pad their last nibble with 0xF). No
  // depth axis, no padding: the device screen cumsums nibble one-hots
  // and differences at row boundaries.
  raw_vector<uint8_t> csr_nib;
  raw_vector<int32_t> csr_off;  // [L+1]
  // Likelihood-mode dense encoding: [L, D] uint16, allele_id (4 bits) |
  // base qual << 4; 0xFFFF = empty / MAPQ-filtered / beyond-cap slot.
  // Feeds the device genotype-likelihood screen.
  raw_vector<uint16_t> ll_pack;
  // Qual-dictionary form: when the tile's elements carry <= 16 distinct
  // base qualities (real BAMs bin to 4-8 levels), ll_pack transcodes to
  // ONE byte per element — allele id in the low nibble, an index into
  // ll_qvals in the high nibble, 0xFF for empty slots. Halves the
  // likelihood screens' H2D (and HBM-read) volume; the kernels decode
  // the same f32 qual values, so candidate flags are bit-identical
  // (tests/test_pallas_kernels.py).
  raw_vector<uint8_t> ll_pack8;
  std::vector<uint8_t> ll_qvals;
  // Mode 3 only: per-element read MAPQ (for alignment-included
  // likelihoods, e.g. the somatic tumor screen). 0 where ll_pack = 0xFFFF.
  raw_vector<uint8_t> ll_mapq;
  // [L, K]
  raw_vector<uint8_t> is_variant;
  raw_vector<uint8_t> is_standard_alt;
  // Screen-mode by-product: per-(locus, allele) element counts over the
  // SAME elements the CSR nibbles encode (id < K, MAPQ-passing). The host
  // fallback screen (no accelerator) thresholds these directly instead of
  // shipping CSR to a device; the TPU path ignores them.
  raw_vector<int32_t> counts;  // [L, K] (csr mode only)
  // Host form of the germline genotype-likelihood screen (requested via
  // ll_screen_margin > 0 on csr tiles): [L] 0/1 candidate flags from the
  // same factored per-allele-sum rule as ops/kernels.py::
  // germline_screen_math, accumulated in f64 (error << margin at any
  // CSR depth, so the flags are a strict superset of exact-argmax
  // variant loci — the host confirm re-evaluates them exactly).
  std::vector<uint8_t> ll_candidates;  // [L] (csr + margin only)
  // allele key table: global sorted keys + per-locus key index lists
  std::vector<uint8_t> key_blob;     // concatenated ref+alt bytes
  std::vector<int64_t> key_ref_off;  // n_keys+1 (start of ref of key i)
  std::vector<int64_t> key_alt_off;  // n_keys (split point within key i)
  raw_vector<int32_t> uniq_key;      // per (locus, rank): global key index
  std::vector<int64_t> uniq_off;     // L+1 offsets into uniq_key
};

inline bool is_standard(uint8_t b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T';
}

static int64_t pad_depth(int64_t depth) {
  int64_t d = 8;
  while (d < depth) d *= 4;
  return d;
}

// Run fn(block_index, thread_index) over nblocks blocks on up to
// max_threads threads; thread_index < thread_count(nblocks, max_threads)
// so callers can keep race-free per-thread scratch.
static int thread_count(int64_t nblocks, int max_threads) {
  if (nblocks <= 0) return 1;
  return (int)std::min<int64_t>(std::max(max_threads, 1), nblocks);
}

// GUAC_PACK_TIMING=1 prints per-pass wall times to stderr (perf tooling).
struct PassTimer {
  bool on;
  std::chrono::steady_clock::time_point last;
  explicit PassTimer()
      : on(getenv("GUAC_PACK_TIMING") != nullptr),
        last(std::chrono::steady_clock::now()) {}
  void mark(const char* name) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[guac_pack] %-12s %7.3f ms\n", name,
            std::chrono::duration<double, std::milli>(now - last).count());
    last = now;
  }
};

// The first row at or after `from` whose locus is >= x (n if none), for
// loci ascending. Loci are distinct integers, so it lies within
// x - loci[from] rows of from: dense loci cost one probe, and a gallop
// (doubling, then bisecting) bounds the rest by O(log gap).
static int64_t row_at_least(const int64_t* loci, int64_t from, int64_t n,
                            int64_t x) {
  if (from >= n || loci[from] >= x) return from;
  int64_t top = std::min(n, from + (x - loci[from]));
  if (loci[top - 1] < x) return top;
  int64_t below = from, step = 1;  // loci[below] < x <= loci[top - 1]
  while (below + step < top && loci[below + step] < x) {
    below += step;
    step *= 2;
  }
  return std::lower_bound(loci + below + 1,
                          loci + std::min(below + step, top), x) -
         loci;
}

static void parallel_blocks(int64_t nblocks, int max_threads,
                            const std::function<void(int64_t, int)>& fn) {
  if (nblocks <= 0) return;
  int nthreads = thread_count(nblocks, max_threads);
  if (nthreads <= 1) {
    for (int64_t b = 0; b < nblocks; b++) fn(b, 0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; t++) {
    pool.emplace_back([&, t]() {
      for (int64_t b = t; b < nblocks; b += nthreads) fn(b, t);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Pack one tile. All input pointers reference caller-owned numpy buffers.
// loci must be sorted ascending. Reads must be sorted by start (within the
// contig selection). l_pad > n_loci allocates sentinel rows (depth 0,
// allele_id -1) so every tile in a run shares the same [L, D] shape.
// Returns an opaque PackedTile handle.
void* guac_pack_tile(
    // per-read columns (n_reads entries)
    int64_t n_reads, const int32_t* ref_id, const int64_t* start,
    const int64_t* end, const int32_t* mapq, const uint16_t* flags,
    const int32_t* mismatches,
    // event arrays
    const int64_t* ev_off, const uint8_t* ev_kind, const uint8_t* ev_base,
    const uint8_t* ev_qual, const uint8_t* ev_mdref,
    // specials
    int64_t n_specials, const int64_t* sp_read, const int64_t* sp_offset,
    const int32_t* sp_kind, const int64_t* sp_payload_offset,
    const int64_t* sp_payload_len, const int32_t* sp_qual,
    const uint8_t* special_payload,
    // tile spec
    int32_t contig_id, int64_t n_loci, const int64_t* loci, int64_t K,
    int64_t depth_pad /* 0 = auto */, int64_t l_pad /* 0 = no padding */,
    // mode 0 = full: every [L, D] per-element tensor.
    // mode 1 = screen: CSR nibble ids only (counting callers: threshold,
    //          vaf-histogram, variant-support) — skips ~90% of fill work.
    // mode 2 = likelihood: dense [L, D] uint16 (allele_id | qual << 4)
    //          only, for the device genotype-likelihood screen.
    // mode 3 = likelihood + per-element MAPQ bytes (alignment-included
    //          likelihoods: the somatic tumor screen).
    int64_t mode,
    // Elements on reads with MAPQ < min_mapq are excluded from modes 1/2
    // (they hold a 0xF/0xFFFF slot and do not enter the allele tables),
    // matching the callers' QualityAlignedReads element filter.
    int64_t min_mapq,
    // optional reference contig bytes (null = resolve from reads)
    const uint8_t* ref_contig, int64_t ref_contig_len,
    // Read-index scan window [scan_lo, scan_hi): the caller may narrow
    // the overlap scan with a binary search over its sorted starts
    // (otherwise a whole-genome run pays an O(n_reads) scan per tile).
    // The per-read predicate still applies, so an over-wide window only
    // costs time. scan_hi <= 0 means "scan everything".
    int64_t scan_lo, int64_t scan_hi,
    // > 0 on csr tiles: also emit likelihood-screen candidate flags with
    // this margin (see PackedTile::ll_candidates). ll_screen_kind picks
    // the model: 1 = germline (base quality only), 2 = tumor
    // (alignment-included: success = (1-err_q)(1-err_m)).
    double ll_screen_margin = 0.0, int64_t ll_screen_kind = 1,
    // skip_nibbles != 0 on csr tiles: the caller screens from the [L, K]
    // counts on host (no device CSR launch), so the nibble blob is never
    // read — the fill fuses into ONE pass per row (counts accumulate per
    // arrival-order distinct code, permuted to allele order at row end)
    // and csr_nib stays empty. Counts/ll_candidates/allele tables are
    // bit-identical to the two-phase fill (same per-bucket f64 add
    // order); pinned by tests/test_pack_columnar.py.
    int64_t skip_nibbles = 0,
    // > 0 with ll_screen_margin: additionally drop candidate rows whose
    // best-genotype NORMALIZED probability cannot reach this phred score
    // (the min-likelihood genotype filter's emission gate,
    // GenotypeFilter.scala:135). The screen's genotype set — unordered
    // pairs of standard dictionary alleles — equals the exact confirm's
    // enumeration (pairs of present standard alleles), so the factored
    // normalized probability here bounds the exact one to fp rounding; a
    // 1-phred safety band makes the drop a strict superset filter
    // (pinned by tests/test_germline_standard.py).
    double ll_screen_min_phred = 0.0) {
  PassTimer timer_;
  PackedTile* t = new PackedTile();
  int64_t L_out = std::max(l_pad, n_loci);
  t->L = L_out;
  t->K = K;
  if (n_loci == 0) {
    t->D = depth_pad > 0 ? depth_pad : 8;
    if (L_out > 0) {
      // Sentinel rows use ref_base 0, matching pad_tile_loci's zero fill.
      t->ref_base.assign(L_out, 0);
      t->depth.assign(L_out, 0);
      t->num_alleles.assign(L_out, 0);
      t->overflow.assign(L_out, 0);
      t->allele_id.assign(L_out * t->D, -1);
      t->qual.assign(L_out * t->D, 0);
      t->mapq.assign(L_out * t->D, 0);
      t->strand.assign(L_out * t->D, 0);
      t->mismatches.assign(L_out * t->D, 0);
      t->edge.assign(L_out * t->D, 0);
      t->read_index.assign(L_out * t->D, -1);
      t->valid.assign(L_out * t->D, 0);
      t->packed_nib.assign(L_out * ((t->D + 1) / 2), 0xFF);
      t->is_variant.assign(L_out * K, 0);
      t->is_standard_alt.assign(L_out * K, 0);
    }
    t->uniq_off.assign(L_out + 1, 0);
    t->key_ref_off.assign(1, 0);
    return t;
  }
  int64_t lo_bound = loci[0];
  int64_t hi_bound = loci[n_loci - 1];

  int max_threads =
      (int)std::min<unsigned>(std::thread::hardware_concurrency(), 16);
  if (const char* env = getenv("GUAC_PACK_THREADS")) {
    int v = atoi(env);
    if (v > 0) max_threads = v;
  }
  if (max_threads < 1) max_threads = 1;

  // Select overlapping reads (columns already sorted by start per contig).
  int64_t r_begin = 0, r_end_idx = n_reads;
  if (scan_hi > 0) {
    r_begin = std::max<int64_t>(0, std::min(scan_lo, n_reads));
    r_end_idx = std::max(r_begin, std::min(scan_hi, n_reads));
  }
  std::vector<int64_t> sel;
  sel.reserve(1024);
  bool sorted = true;
  for (int64_t r = r_begin; r < r_end_idx; r++) {
    if (ref_id[r] != contig_id) continue;
    if (end[r] <= lo_bound || start[r] > hi_bound) continue;
    if (!sel.empty() && start[r] < start[sel.back()]) sorted = false;
    sel.push_back(r);
  }
  if (!sorted)
    std::stable_sort(sel.begin(), sel.end(), [&](int64_t a, int64_t b) {
      return start[a] < start[b];
    });

  timer_.mark("select");
  // Block decomposition of the locus axis: each block owns its rows, so
  // every per-row fill below is race-free. Reads are bucketed into every
  // block they overlap, preserving sel (start-sorted) order per block so
  // slot assignment matches the sequential packers.
  // 8 blocks per thread (strided assignment): depth is not uniform along
  // the locus axis (coverage bands/spikes), so per-thread single blocks
  // leave one thread with most of the elements.
  int64_t block_size = std::max<int64_t>(
      256, (n_loci + max_threads * 8 - 1) / (max_threads * 8));
  int64_t nblocks = (n_loci + block_size - 1) / block_size;
  // Row range [lo, hi) per read in one forward walk: sel is start-sorted,
  // so a read's first row (first locus >= start) never lies before the
  // previous read's. Pass 1 rides along: depth per locus via an interval
  // diff array — O(reads + loci), not O(elements): each read covers a
  // contiguous row range.
  std::vector<std::pair<int64_t, int64_t>> read_rows(sel.size());
  std::vector<int32_t> diff((size_t)n_loci + 1, 0);
  int64_t cursor = 0, max_span = 0;
  for (size_t i = 0; i < sel.size(); i++) {
    int64_t r = sel[i];
    cursor = row_at_least(loci, cursor, n_loci, start[r]);
    int64_t hi = row_at_least(loci, cursor, n_loci, end[r]);
    read_rows[i] = {cursor, hi};
    if (hi <= cursor) continue;
    max_span = std::max(max_span, hi - cursor);
    diff[(size_t)cursor]++;
    diff[(size_t)hi]--;
  }
  // The first read whose first row is >= row (first rows ascend in sel).
  auto first_read_at = [&](int64_t row) {
    return std::partition_point(
               read_rows.begin(), read_rows.end(),
               [&](const std::pair<int64_t, int64_t>& rr) {
                 return rr.first < row;
               }) -
           read_rows.begin();
  };
  // Block b's reads, in sel order, each fill pass takes on the block's own
  // thread: those that reach into it from earlier rows (their first rows
  // lie at most max_span rows before it), then those whose first row lies
  // in it.
  auto block_reads = [&](int64_t b, std::vector<int64_t>& members) {
    int64_t bs = b * block_size;
    int64_t be = std::min(bs + block_size, n_loci);
    members.clear();
    for (int64_t i = first_read_at(bs - max_span), e = first_read_at(be);
         i < e; i++) {
      auto [lo, hi] = read_rows[(size_t)i];
      if (hi > std::max(lo, bs)) members.push_back(i);
    }
  };

  timer_.mark("read_rows");
  // Each block's CSR row bytes, for the offsets the CSR pass writes.
  t->depth.resize(L_out);
  std::fill(t->depth.begin() + n_loci, t->depth.end(), 0);
  std::vector<int64_t> block_nib((size_t)nblocks, 0);
  int64_t max_depth = 0;
  int32_t run = 0;
  for (int64_t b = 0; b < nblocks; b++)
    for (int64_t row = b * block_size;
         row < std::min((b + 1) * block_size, n_loci); row++) {
      run += diff[(size_t)row];
      t->depth[row] = run;
      max_depth = std::max<int64_t>(max_depth, run);
      block_nib[(size_t)b] += (run + 1) / 2;
    }
  int64_t D =
      depth_pad > 0 ? depth_pad : pad_depth(std::max<int64_t>(max_depth, 1));
  // Likelihood-mode depth cap (matches pack/columnar.py
  // LIKELIHOOD_DEPTH_CAP): deeper rows overflow to the exact host path.
  if (mode == 2 || mode == 3) D = std::min<int64_t>(D, 16384);
  t->D = D;
  // Nibble packing reserves 0xF for empty slots, so it only exists for
  // K <= 15 (always true for the default K=8); otherwise Python callers
  // see an empty array and pack on host.
  bool emit_nib = K <= 15;
  if (K > 15) mode = 0;  // compact encodings reserve 0xF for empty slots
  bool full = mode == 0;
  bool csr = mode == 1;        // CSR counting screen
  bool ll = mode == 2 || mode == 3;  // dense likelihood screen
  bool llm = mode == 3;        // + per-element MAPQ
  int64_t Dp = (D + 1) / 2;  // packed-nibble row width

  timer_.mark("depth");
  // Pass 2: reference base per locus. Sentinel rows (>= n_loci) stay 0 to
  // match pad_tile_loci's zero fill. Without a reference contig the
  // locus-major sweep (CSR and likelihood modes) resolves each row's base
  // itself, from the reads it already walks in start order; the full mode
  // fills read-major, so it resolves the bases here first.
  t->ref_base.assign(L_out, 0);
  std::fill(t->ref_base.begin(), t->ref_base.begin() + n_loci, 'N');
  if (ref_contig != nullptr) {
    for (int64_t i = 0; i < n_loci; i++)
      if (loci[i] >= 0 && loci[i] < ref_contig_len)
        t->ref_base[i] = ref_contig[loci[i]];
  } else if (full) {
    parallel_blocks(nblocks, max_threads, [&](int64_t b, int) {
      int64_t bs = b * block_size;
      int64_t be = std::min(bs + block_size, n_loci);
      std::vector<int64_t> members;
      block_reads(b, members);
      for (int64_t i : members) {
        int64_t r = sel[(size_t)i];
        auto [lo, hi] = read_rows[(size_t)i];
        const uint8_t* mdr = ev_mdref + ev_off[r];
        for (int64_t row = std::max(lo, bs); row < std::min(hi, be); row++) {
          if (t->ref_base[row] == 'N') {
            uint8_t bch = mdr[loci[row] - start[r]];
            if (is_standard(bch)) t->ref_base[row] = bch;
          }
        }
      }
    });
    timer_.mark("ref_base");
  }
  // Specials lookup: read -> (offset -> special index).
  std::unordered_map<int64_t, std::unordered_map<int64_t, int64_t>>
      special_by_read;
  for (int64_t s = 0; s < n_specials; s++)
    special_by_read[sp_read[s]][sp_offset[s]] = s;

  // Pass 3 (full mode): fill [L, D] arrays + per-element allele keys
  // (parallel over blocks; only long-key interning is shared, behind a
  // mutex). The arrays are allocated uninitialized: data cells (slot <
  // depth) are written here / in pass 4, padding cells by the parallel
  // padding pass below — no serial whole-array memset. The likelihood
  // modes' sweep writes every cell of its rows itself.
  // Screen mode is CSR over elements: no [L, D] grids, no depth cap (so
  // no depth-overflow host fallbacks), rows byte-aligned in csr_nib.
  // Each block's rows start at the bytes of the blocks before it; the CSR
  // pass writes their offsets.
  std::vector<int64_t> block_nib_off((size_t)nblocks + 1, 0);
  if (full) {
    t->allele_id.resize(L_out * D);
    t->qual.resize(L_out * D);
    t->mapq.resize(L_out * D);
    t->strand.resize(L_out * D);
    t->mismatches.resize(L_out * D);
    t->edge.resize(L_out * D);
    t->read_index.resize(L_out * D);
    t->valid.resize(L_out * D);
    t->packed_nib.resize(emit_nib ? L_out * Dp : 0);
  } else if (ll) {
    // The sweep writes every cell of rows < n_loci; sentinel rows are
    // empty slots.
    t->ll_pack.resize(L_out * D);
    memset(t->ll_pack.data() + n_loci * D, 0xFF,
           (size_t)((L_out - n_loci) * D) * sizeof(uint16_t));
    if (llm) {
      t->ll_mapq.resize(L_out * D);
      memset(t->ll_mapq.data() + n_loci * D, 0, (size_t)((L_out - n_loci) * D));
    }
  } else {
    for (int64_t b = 0; b < nblocks; b++)
      block_nib_off[(size_t)b + 1] =
          block_nib_off[(size_t)b] + block_nib[(size_t)b];
    t->csr_off.resize(L_out + 1);
    t->csr_off[0] = 0;
    std::fill(t->csr_off.begin() + n_loci + 1, t->csr_off.end(),
              (int32_t)block_nib_off[(size_t)nblocks]);
    if (!skip_nibbles)
      t->csr_nib.resize((size_t)block_nib_off[(size_t)nblocks]);
  }
  t->overflow.assign(L_out, 0);

  timer_.mark("alloc");
  // Per-element allele keys: most are 2-byte (ref, alt); store compactly as
  // int32 codes; special/long keys in a side map.
  // Code scheme: BASE/MATCH: 0x10000 | ref<<8 | alt ; MID_DEL: 0x20000|ref ;
  // CLIPPED: 0x30000 ; long keys: 0x40000 + index into long_keys.
  std::vector<AlleleKey> long_keys;
  std::map<AlleleKey, int32_t> long_key_ids;
  std::mutex long_key_mu;
  // The CSR and likelihood modes run a single locus-major fill pass
  // (below) and need no per-element code buffer (at 9M loci / 140M
  // elements this buffer was >0.5 GB written+reread across two read-major
  // passes). Only the full mode fills read-major.
  raw_vector<int32_t> elem_code(full ? n_loci * D : 0);
  std::vector<int32_t> fill(full ? n_loci : 0, 0);

  // Parallel padding pass (full mode only — CSR has no padding, and the
  // likelihood sweep pads each row as it writes it): every cell at slot
  // >= min(depth, D) gets the sentinel fill (and sentinel L-pad rows are
  // fully padded). Runs over ALL L_out rows, decomposed independently of
  // the read blocks.
  if (full) {
    timer_.mark("codes_alloc");
    int64_t pad_block = std::max<int64_t>(
        256, (L_out + max_threads - 1) / max_threads);
    int64_t pad_nblocks = (L_out + pad_block - 1) / pad_block;
    parallel_blocks(pad_nblocks, max_threads, [&](int64_t b, int) {
      int64_t bs = b * pad_block;
      int64_t be = std::min(bs + pad_block, L_out);
      for (int64_t row = bs; row < be; row++) {
        int64_t dn =
            row < n_loci ? std::min<int64_t>(t->depth[row], D) : 0;
        int64_t base = row * D;
        for (int64_t s = dn; s < D; s++) {
          t->allele_id[base + s] = -1;
          t->qual[base + s] = 0;
          t->mapq[base + s] = 0;
          t->strand[base + s] = 0;
          t->mismatches[base + s] = 0;
          t->edge[base + s] = 0;
          t->read_index[base + s] = -1;
          t->valid[base + s] = 0;
        }
        // Nibble row: all-0xF; data nibbles are patched in pass 4.
        if (emit_nib)
          memset(t->packed_nib.data() + row * Dp, 0xFF, (size_t)Dp);
      }
    });
    timer_.mark("padding");
  }
  // Distinct short codes (< 0x40000) are collected during the fill with
  // per-thread seen bitmaps — long codes need no tracking, since every
  // interned long key is by construction used by some element.
  int pass3_threads = thread_count(nblocks, max_threads);
  std::vector<std::vector<uint8_t>> thread_seen(
      (size_t)pass3_threads, std::vector<uint8_t>(0x40000, 0));
  std::vector<std::vector<int32_t>> thread_distinct((size_t)pass3_threads);
  // Likelihood modes: a bitmap of the base qualities each thread writes
  // into ll_pack (elements with an id below K), for the qual dictionary.
  std::vector<std::array<uint64_t, 4>> thread_qseen(
      ll ? (size_t)pass3_threads : 0, std::array<uint64_t, 4>{});
  // Per-block uniq tables (stitched serially at the end). The full mode
  // stores global sorted-key RANKS (pass 4); the single pass stores raw
  // CODES, which the stitch remaps once the global key table exists.
  std::vector<std::vector<int32_t>> block_uniq((size_t)nblocks);
  t->num_alleles.assign(L_out, 0);
  // [L, K] tables: the fill passes zero each block's rows on its own
  // thread (zero_rows), and sentinel rows are zeroed here.
  t->is_variant.resize(L_out * K);
  t->is_standard_alt.resize(L_out * K);
  if (csr) t->counts.resize(L_out * K);
  auto zero_rows = [&](int64_t lo, int64_t hi) {
    size_t at = (size_t)(lo * K), n = (size_t)((hi - lo) * K);
    memset(t->is_variant.data() + at, 0, n);
    memset(t->is_standard_alt.data() + at, 0, n);
    if (csr) memset(t->counts.data() + at, 0, n * sizeof(int32_t));
  };
  zero_rows(n_loci, L_out);
  bool ll_screen = csr && ll_screen_margin > 0.0 && K <= 16;
  bool ll_tumor = ll_screen && ll_screen_kind == 2;
  if (ll_screen) t->ll_candidates.assign(L_out, 0);
  // Per-quality log terms of the factored likelihood screens: an
  // element's m=0 genotype contribution is x = log(2*(1-pc)) and its
  // m=2 contribution y = log(2*pc), where the success probability pc is
  // 1 - 10^(-q/10) for the germline model (kernels.py::
  // germline_screen_math) and (1-err_q)(1-err_m) for the tumor model
  // (kernels.py::tumor_screen_math), indexed by quality (germline) or
  // quality * 256 + MAPQ (tumor).
  static double ll_x[256], ll_y[256];
  static double llm_x[256 * 256], llm_y[256 * 256];
  static std::once_flag ll_lut_once, llm_lut_once;
  if (ll_screen && !ll_tumor)
    std::call_once(ll_lut_once, [] {
      for (int q = 0; q < 256; q++) {
        double err = pow(10.0, q / -10.0);
        ll_x[q] = log(2.0 * err);
        ll_y[q] = q == 0 ? -INFINITY : log(2.0 - 2.0 * err);
      }
    });
  if (ll_tumor)
    std::call_once(llm_lut_once, [] {
      for (int q = 0; q < 256; q++) {
        double err_q = pow(10.0, q / -10.0);
        for (int m = 0; m < 256; m++) {
          double err_m = pow(10.0, m / -10.0);
          double pc = (1.0 - err_q) * (1.0 - err_m);
          double one_minus = err_q + err_m - err_q * err_m;
          llm_x[q * 256 + m] = log(2.0 * one_minus);
          llm_y[q * 256 + m] =
              pc > 0.0 ? log(2.0 * pc) : -INFINITY;
        }
      }
    });
  t->uniq_off.assign(L_out + 1, 0);

  if (!full) {
    // --- Single pass: locus-major fill (CSR and likelihood modes) ------
    // One sweep per block: a sliding active-read window delivers each
    // row's elements in read-start order (identical slot order to the
    // read-major fill); the row's distinct codes sort by allele order
    // in-place, assigning dense ids, then nibbles, counts and flags (CSR)
    // or the row's ll_pack / ll_mapq cells and padding (likelihood) in one
    // touch per element. Replaces the two read-major passes (elem_code
    // write + reread) the full mode still uses. The likelihood rows take
    // their first D elements; a deeper row overflows.
    parallel_blocks(nblocks, max_threads, [&](int64_t blk, int th) {
      int64_t bs = blk * block_size;
      int64_t be = std::min(bs + block_size, n_loci);
      std::vector<int64_t> members;
      block_reads(blk, members);
      std::vector<uint8_t>& seen_short = thread_seen[(size_t)th];
      std::vector<int32_t>& distinct_short = thread_distinct[(size_t)th];
      auto& uniq = block_uniq[(size_t)blk];
      zero_rows(bs, be);
      int64_t nib_off = block_nib_off[(size_t)blk];
      // Active-read window: two parallel compact arrays — the event-
      // pointer (pre-biased by -start so the row's event indexes as
      // kindp[locus]) and the expiry row. Parallel 8+8 bytes keep the
      // compaction copy small; everything else the hot loop needs hangs
      // off the same entry.
      std::vector<int64_t> act_bias;  // ev_off[r] - start[r]
      std::vector<int64_t> act_hi;    // exclusive end row
      std::vector<int32_t> act_member;  // member index (cold fields)
      // Per-read facts hoisted to window entry (read-major loads once,
      // not per element): MAPQ-filtered flag and clamped MAPQ byte.
      std::vector<uint8_t> act_filt;
      std::vector<uint8_t> act_mapq;
      act_bias.reserve(256);
      act_hi.reserve(256);
      act_member.reserve(256);
      act_filt.reserve(256);
      act_mapq.reserve(256);
      size_t next_m = 0;
      std::vector<int32_t> row_codes;
      std::vector<uint8_t> row_quals;  // parallel to row_codes (ll screen)
      std::vector<uint8_t> row_mapqs;  // parallel (tumor ll screen)
      std::vector<int32_t> distinct;
      std::vector<int32_t> sorted_codes;
      double ll_c[16], ll_g[16];
      // Fused mode (skip_nibbles): per-arrival-id accumulators, parallel
      // to `distinct`. Counts/ll sums accumulate during the single
      // element sweep and permute to allele order at row end — no
      // row_codes buffer, no second per-element pass, no nibble writes.
      const bool skip_nib = csr && skip_nibbles != 0;
      bool ll_live = false;  // per-row: lazy ll sums went live
      std::vector<int32_t> cnt_arr;
      std::vector<double> llc_arr;
      std::vector<double> llg_arr;
      // Likelihood modes: the sweep writes each element's quality
      // (q << 4) and MAPQ cell as it meets it, and its arrival id + 1 (0:
      // MAPQ-filtered) into `arrival`; at row end `to_id` maps arrival ids
      // to allele-order ids, ORed into the cells. `row_q` marks the row's
      // qualities, which the thread's bitmap takes when every element
      // keeps its cell (at most K alleles).
      const bool arrival_ids = skip_nib || ll;
      std::vector<uint16_t> arrival(ll ? (size_t)D : 0);
      std::vector<uint16_t> to_id;
      uint16_t* ll_row = nullptr;
      uint8_t* mq_row = nullptr;
      uint64_t row_q[4];
      // Per-row base-byte LUTs: nearly every element is an EV_BASE code
      // (match/mismatch), whose code varies only in the base byte at a
      // fixed row — one 256-entry table turns both distinct-collection
      // and code->id mapping into single indexed loads instead of linear
      // scans over the row's distinct codes. Reset via touched lists.
      uint8_t seen_base[256] = {0};
      int16_t id_base[256];
      uint8_t touched[256];
      int n_touched = 0;
      // Integer order key that sorts short codes identically to their
      // (ref, alt) allele byte order (empty-before-nonempty, then byte
      // value): ref/alt each encode as 0 when empty else 0x100 | byte.
      // Long keys get the sentinel and force the comparator path.
      auto order_of = [](int32_t code) -> uint32_t {
        int32_t tag = code & 0x70000;
        if (tag == 0x10000)
          return ((0x100u | ((code >> 8) & 0xff)) << 16) |
                 (0x100u | (code & 0xff));
        if (tag == 0x20000) return (0x100u | (code & 0xff)) << 16;
        if (tag == 0x30000) return 0;
        return 0xFFFFFFFFu;
      };
      // A distinct code's arrival id: its index in `distinct`.
      auto arrival_of = [&](int32_t c) -> int32_t {
        if ((c & 0x70000) == 0x10000) return id_base[c & 0xff];
        for (size_t d = 0; d < distinct.size(); d++)
          if (distinct[d] == c) return (int32_t)d;
        return -1;
      };
      for (int64_t row = bs; row < be; row++) {
        int64_t locus = loci[row];
        while (next_m < members.size() &&
               read_rows[(size_t)members[next_m]].first <= row) {
          int64_t i = members[next_m];
          if (read_rows[(size_t)i].second > row) {
            int64_t r = sel[(size_t)i];
            act_bias.push_back(ev_off[r] - start[r]);
            act_hi.push_back(read_rows[(size_t)i].second);
            act_member.push_back((int32_t)i);
            int32_t m = mapq[r];
            act_filt.push_back(min_mapq > 0 && m < min_mapq ? 1 : 0);
            act_mapq.push_back((uint8_t)(m < 0 ? 0 : (m > 255 ? 255 : m)));
          }
          next_m++;
        }
        int32_t dn = t->depth[row];
        // Device counts return as int16, and likelihood rows hold D
        // elements; deeper rows go through the exact host path like any
        // other overflow row.
        if (dn > (ll ? D : 32767)) t->overflow[row] = 1;
        uint8_t* nib_row = nullptr;
        if (ll) {
          ll_row = t->ll_pack.data() + row * D;
          if (llm) mq_row = t->ll_mapq.data() + row * D;
          row_q[0] = row_q[1] = row_q[2] = row_q[3] = 0;
        } else if (!skip_nib) {
          nib_row = t->csr_nib.data() + nib_off;
          memset(nib_row, 0xFF, (size_t)((dn + 1) / 2));
          row_codes.clear();
          if (ll_screen) row_quals.clear();
          if (ll_tumor) row_mapqs.clear();
        } else {
          cnt_arr.clear();
          if (ll_screen) {
            llc_arr.clear();
            llg_arr.clear();
          }
          ll_live = false;
        }
        if (csr) {
          nib_off += (dn + 1) / 2;
          t->csr_off[row + 1] = (int32_t)nib_off;
        }
        distinct.clear();
        if (ref_contig == nullptr) {
          // The row's reference base: the first read over it, in start
          // order, whose MD reference byte is a standard base (MAPQ-
          // filtered reads count), else N.
          for (size_t a = 0; a < act_hi.size(); a++) {
            if (act_hi[a] <= row) continue;  // expired
            uint8_t b = ev_mdref[act_bias[a] + locus];
            if (is_standard(b)) {
              t->ref_base[row] = b;
              break;
            }
          }
        }
        uint8_t rb = t->ref_base[row];
        size_t w = 0;
        size_t n_act = act_hi.size();
        for (size_t a = 0; a < n_act; a++) {
          if (act_hi[a] <= row) continue;  // expired
          int64_t bias = act_bias[a];
          if (w != a) {
            act_hi[w] = act_hi[a];
            act_bias[w] = bias;
            act_member[w] = act_member[a];
            act_filt[w] = act_filt[a];
            act_mapq[w] = act_mapq[a];
          }
          size_t me = w++;
          // Past the likelihood row's D slots: no element, no tables.
          if (ll && (int64_t)me >= D) continue;
          if (act_filt[me]) {
            // MAPQ-filtered: holds its slot (0xF nibble, 0xFFFF cell), no
            // tables.
            if (ll) {
              ll_row[me] = 0xFFFF;
              if (llm) mq_row[me] = 0;
              arrival[me] = 0;
            } else if (!skip_nib) {
              row_codes.push_back(-2);
              if (ll_screen) row_quals.push_back(0);
              if (ll_tumor) row_mapqs.push_back(0);
            }
            continue;
          }
          int64_t ei = bias + locus;
          uint8_t kind = ev_kind[ei];
          int32_t code;
          switch (kind) {
            case EV_BASE:
              code = 0x10000 | ((int32_t)rb << 8) | ev_base[ei];
              break;
            case EV_MID_DELETION:
              code = 0x20000 | ev_mdref[ei];
              break;
            case EV_CLIPPED:
              code = 0x30000;
              break;
            default: {  // INSERTION or DELETION anchor
              int64_t r = sel[(size_t)act_member[me]];
              int64_t off = locus - start[r];
              AlleleKey key;
              auto sp_it = special_by_read.find(r);
              if (sp_it != special_by_read.end()) {
                auto it = sp_it->second.find(off);
                if (it != sp_it->second.end()) {
                  int64_t s = it->second;
                  std::string payload(
                      reinterpret_cast<const char*>(special_payload +
                                                    sp_payload_offset[s]),
                      sp_payload_len[s]);
                  if (sp_kind[s] == EV_INSERTION) {
                    key.ref = payload.substr(0, 1);
                    key.alt = payload;
                  } else {
                    key.ref = std::string(1, (char)rb) + payload;
                    key.alt = key.ref.substr(0, 1);
                  }
                }
              }
              int32_t id;
              {
                std::lock_guard<std::mutex> lock(long_key_mu);
                auto found = long_key_ids.find(key);
                if (found == long_key_ids.end()) {
                  id = (int32_t)long_keys.size();
                  long_keys.push_back(key);
                  long_key_ids[key] = id;
                } else {
                  id = found->second;
                }
              }
              code = 0x40000 + id;
              break;
            }
          }
          if (ll) {
            uint8_t q = ev_qual[ei];
            ll_row[me] = (uint16_t)(q << 4);
            if (llm) mq_row[me] = act_mapq[me];
            row_q[q >> 6] |= 1ull << (q & 63);
          } else if (!skip_nib) {
            row_codes.push_back(code);
            if (ll_screen) row_quals.push_back(ev_qual[ei]);
            if (ll_tumor) row_mapqs.push_back(act_mapq[me]);
          }
          int32_t aid = -1;
          if ((code & 0x70000) == 0x10000) {
            uint8_t b = (uint8_t)(code & 0xff);
            if (!seen_base[b]) {
              seen_base[b] = 1;
              touched[n_touched++] = b;
              if (arrival_ids) id_base[b] = (int16_t)distinct.size();
              if (skip_nib) {
                cnt_arr.push_back(0);
                if (ll_screen) {
                  llc_arr.push_back(0.0);
                  llg_arr.push_back(0.0);
                }
              }
              distinct.push_back(code);
              if (!seen_short[code]) {
                seen_short[code] = 1;
                distinct_short.push_back(code);
              }
            }
            if (arrival_ids) aid = id_base[b];
          } else {
            if (code < 0x40000 && !seen_short[code]) {
              seen_short[code] = 1;
              distinct_short.push_back(code);
            }
            int32_t found = -1;
            for (size_t d = 0; d < distinct.size(); d++)
              if (distinct[d] == code) {
                found = (int32_t)d;
                break;
              }
            if (found < 0) {
              found = (int32_t)distinct.size();
              distinct.push_back(code);
              if (skip_nib) {
                cnt_arr.push_back(0);
                if (ll_screen) {
                  llc_arr.push_back(0.0);
                  llg_arr.push_back(0.0);
                }
              }
            }
            if (arrival_ids) aid = found;
          }
          if (ll) arrival[me] = (uint16_t)(aid + 1);
          if (skip_nib) {
            cnt_arr[(size_t)aid]++;
            if (ll_screen) {
              // Lazy ll accumulation: single-allele rows (the vast
              // majority) never need the f64 LUT sums — their candidate
              // verdict and normalized probability are allele-count-only
              // facts (one genotype: p = 1). Sums go live when a SECOND
              // distinct code registers; the catch-up walks the already-
              // processed window entries (all carrying arrival id 0) in
              // original element order, so every per-bucket f64 sequence
              // matches the eager two-phase fill bit-for-bit.
              if (!ll_live && distinct.size() >= 2) {
                for (size_t cu = 0; cu < me; cu++) {
                  if (act_filt[cu]) continue;
                  int64_t cei = act_bias[cu] + locus;
                  if (ll_tumor) {
                    int idx =
                        (int)ev_qual[cei] * 256 + (int)act_mapq[cu];
                    llc_arr[0] += llm_x[idx];
                    llg_arr[0] += llm_y[idx];
                  } else {
                    uint8_t q = ev_qual[cei];
                    llc_arr[0] += ll_x[q];
                    llg_arr[0] += ll_y[q];
                  }
                }
                ll_live = true;
              }
              if (ll_live) {
                if (ll_tumor) {
                  int idx = (int)ev_qual[ei] * 256 + (int)act_mapq[me];
                  llc_arr[(size_t)aid] += llm_x[idx];
                  llg_arr[(size_t)aid] += llm_y[idx];
                } else {
                  uint8_t q = ev_qual[ei];
                  llc_arr[(size_t)aid] += ll_x[q];
                  llg_arr[(size_t)aid] += ll_y[q];
                }
              }
            }
          }
        }
        act_bias.resize(w);
        act_hi.resize(w);
        act_member.resize(w);
        act_filt.resize(w);
        act_mapq.resize(w);
        // Sort this locus's distinct codes by allele order (ties — equal
        // decoded keys from different codes — by code, deterministic).
        // Short codes order by their integer order key (no decoding);
        // rows containing a long key fall back to the full comparator.
        sorted_codes.assign(distinct.begin(), distinct.end());
        bool has_long = false;
        for (int32_t d : sorted_codes)
          if ((d & 0x70000) == 0x40000) {
            has_long = true;
            break;
          }
        // Other blocks intern long keys while this one reads them: a
        // push_back that grows long_keys moves every key, so a row with
        // a long key reads the table under its lock.
        std::unique_lock<std::mutex> long_lock(long_key_mu, std::defer_lock);
        if (has_long) long_lock.lock();
        if (!has_long) {
          // Insertion sort by order key: n_distinct is tiny (~ploidy +
          // error kinds), and this avoids std::sort + memcmp dispatch
          // per row (8M shallow rows pay it otherwise).
          for (size_t a = 1; a < sorted_codes.size(); a++) {
            int32_t c = sorted_codes[a];
            uint32_t oc = order_of(c);
            size_t b = a;
            while (b > 0) {
              uint32_t ob = order_of(sorted_codes[b - 1]);
              if (ob < oc || (ob == oc && sorted_codes[b - 1] < c)) break;
              sorted_codes[b] = sorted_codes[b - 1];
              b--;
            }
            sorted_codes[b] = c;
          }
        } else {
          std::sort(sorted_codes.begin(), sorted_codes.end(),
                    [&](int32_t a, int32_t b) {
                      char ba[2], bb[2];
                      KeyView va = code_view(a, long_keys, ba);
                      KeyView vb = code_view(b, long_keys, bb);
                      if (view_less(va, vb)) return true;
                      if (view_less(vb, va)) return false;
                      return a < b;
                    });
        }
        int64_t n_distinct = (int64_t)sorted_codes.size();
        if (n_distinct > K) t->overflow[row] = 1;
        t->num_alleles[row] = (int16_t)std::min<int64_t>(n_distinct, K);
        for (int64_t u = 0; u < n_distinct; u++) {
          uniq.push_back(sorted_codes[u]);
          if (u < K) {
            char b2[2];
            KeyView v = code_view(sorted_codes[u], long_keys, b2);
            bool is_var =
                v.rlen != v.alen ||
                memcmp(v.ref, v.alt, (size_t)v.rlen) != 0;
            t->is_variant[row * K + u] = is_var ? 1 : 0;
            bool std_alt = true;
            for (int32_t c = 0; c < v.alen; c++)
              if (!is_standard((uint8_t)v.alt[c])) std_alt = false;
            t->is_standard_alt[row * K + u] = std_alt ? 1 : 0;
          }
        }
        if (has_long) long_lock.unlock();
        t->uniq_off[row + 1] = n_distinct;  // summed by the stitch
        int32_t* counts_row = csr ? t->counts.data() + row * K : nullptr;
        int32_t n_ll_valid = 0;
        if (ll) {
          // OR each element's allele-order id into its cell (id 0, the
          // only one of a one-allele row, is there already); past K
          // alleles the cell empties. A filtered element's arrival 0 maps
          // to 0 and leaves its 0xFFFF cell.
          int32_t dd = (int32_t)std::min<int64_t>(dn, D);
          if (n_distinct > 1) {
            to_id.assign(distinct.size() + 1, 0);
            for (int64_t u = 0; u < n_distinct; u++)
              to_id[(size_t)arrival_of(sorted_codes[(size_t)u]) + 1] =
                  (uint16_t)(u < K ? u : 0xFFFF);
          }
          if (n_distinct > K) {
            row_q[0] = row_q[1] = row_q[2] = row_q[3] = 0;
            for (int32_t slot = 0; slot < dd; slot++) {
              if (!arrival[(size_t)slot]) continue;
              uint16_t id = to_id[arrival[(size_t)slot]];
              if (id == 0xFFFF) {
                ll_row[slot] = 0xFFFF;
                continue;
              }
              ll_row[slot] |= id;
              uint8_t q = (uint8_t)(ll_row[slot] >> 4);
              row_q[q >> 6] |= 1ull << (q & 63);
            }
          } else if (n_distinct > 1) {
            for (int32_t slot = 0; slot < dd; slot++)
              ll_row[slot] |= to_id[arrival[(size_t)slot]];
          }
          for (int i = 0; i < 4; i++) thread_qseen[(size_t)th][i] |= row_q[i];
          // Padding out to D.
          std::fill(ll_row + dd, ll_row + D, (uint16_t)0xFFFF);
          if (llm) memset(mq_row + dd, 0, (size_t)(D - dd));
        } else if (skip_nib) {
          // Fused mode: counts/ll sums already accumulated per arrival
          // id during the sweep — permute into allele (sorted) order.
          // Per-bucket f64 add order matches the two-phase fill (same
          // element order within each bucket), so ll_c/ll_g and counts
          // are bit-identical to it.
          int32_t na = (int32_t)std::min<int64_t>(n_distinct, K);
          for (int32_t u = 0; u < na; u++) {
            int32_t ai = arrival_of(sorted_codes[(size_t)u]);
            counts_row[u] = cnt_arr[(size_t)ai];
            n_ll_valid += cnt_arr[(size_t)ai];
            if (ll_screen) {
              ll_c[u] = llc_arr[(size_t)ai];
              ll_g[u] = llg_arr[(size_t)ai];
            }
          }
        } else {
        // Map each element's code to its dense id (EV_BASE via the LUT,
        // other kinds via a scan of the few distinct); write nibble +
        // count.
        for (int64_t u = 0; u < n_distinct; u++)
          if ((sorted_codes[(size_t)u] & 0x70000) == 0x10000)
            id_base[sorted_codes[(size_t)u] & 0xff] = (int16_t)u;
        dn = (int32_t)std::min<int64_t>(dn, (int64_t)row_codes.size());
        if (ll_screen) {
          memset(ll_c, 0, sizeof(ll_c));
          memset(ll_g, 0, sizeof(ll_g));
        }
        for (int32_t slot = 0; slot < dn; slot++) {
          int32_t code = row_codes[(size_t)slot];
          if (code < 0) continue;
          int64_t id;
          if ((code & 0x70000) == 0x10000) {
            id = id_base[code & 0xff];
          } else {
            id = -1;
            for (int64_t u = 0; u < n_distinct; u++)
              if (sorted_codes[(size_t)u] == code) {
                id = u;
                break;
              }
          }
          if (id >= 0 && id < K) {
            counts_row[id]++;
            if (ll_screen) {
              if (ll_tumor) {
                int idx = (int)row_quals[(size_t)slot] * 256 +
                          (int)row_mapqs[(size_t)slot];
                ll_c[id] += llm_x[idx];
                ll_g[id] += llm_y[idx];
              } else {
                uint8_t q = row_quals[(size_t)slot];
                ll_c[id] += ll_x[q];
                ll_g[id] += ll_y[q];
              }
              n_ll_valid++;
            }
            int shift = (slot & 1) * 4;
            nib_row[slot >> 1] = (uint8_t)(
                (nib_row[slot >> 1] & ~(0xF << shift)) |
                ((int)id << shift));
          }
        }
        }
        if (ll_screen && n_ll_valid > 0) {
          // Pair scores from the per-allele sums (the common all-element
          // term cancels): ll(i,j) = -c_i - c_j (i != j), -c_i + g_i
          // (i == i). Candidate when the best variant genotype comes
          // within the margin of the best reference genotype.
          const uint8_t* iv = t->is_variant.data() + row * K;
          const uint8_t* sa = t->is_standard_alt.data() + row * K;
          int32_t na = (int32_t)std::min<int64_t>(n_distinct, K);
          double best_var = -INFINITY, best_ref = -INFINITY;
          for (int32_t i = 0; i < na; i++) {
            if (!sa[i]) continue;
            for (int32_t j = i; j < na; j++) {
              if (!sa[j]) continue;
              double score =
                  i == j ? -ll_c[i] + ll_g[i] : -ll_c[i] - ll_c[j];
              if (iv[i] || iv[j]) {
                if (score > best_var) best_var = score;
              } else {
                if (score > best_ref) best_ref = score;
              }
            }
          }
          // Rows with no standard VARIANT allele can never emit (the
          // argmax pair cannot contain one) — and without this guard
          // the eager and lazy fills disagree when every score is -inf
          // (IEEE -inf >= -inf is true; found by the round-5 fuzz
          // campaign). Same guard in the XLA/Pallas kernels.
          bool has_var = false;
          for (int32_t i = 0; i < na; i++)
            if (sa[i] && iv[i]) {
              has_var = true;
              break;
            }
          bool cand = has_var && best_var >= best_ref - ll_screen_margin;
          if (cand && ll_screen_min_phred > 0.0) {
            // Emission-gate prefilter in the screen: the best genotype's
            // normalized probability p = exp(s_max) / sum_k exp(s_k)
            // over the SAME genotype set the exact confirm enumerates,
            // so GQ(p) bounds the exact GQ (to fp rounding; 1-phred
            // safety band). Rows the min-likelihood filter must drop
            // never reach the sparse confirm.
            double smax = std::max(best_var, best_ref);
            if (std::isfinite(smax)) {
              double sum = 0.0;
              for (int32_t i = 0; i < na; i++) {
                if (!sa[i]) continue;
                for (int32_t j = i; j < na; j++) {
                  if (!sa[j]) continue;
                  double score =
                      i == j ? -ll_c[i] + ll_g[i] : -ll_c[i] - ll_c[j];
                  sum += exp(score - smax);
                }
              }
              double one_minus = 1.0 - (1.0 / sum - 1e-10);
              if (one_minus > 0.0) {
                double gq = -10.0 * log10(one_minus);
                if (gq < ll_screen_min_phred - 1.0) cand = false;
              }
            }
          }
          t->ll_candidates[row] = cand ? 1 : 0;
        }
        // Reset the per-row LUTs via the touched list.
        for (int i = 0; i < n_touched; i++) seen_base[touched[i]] = 0;
        n_touched = 0;
      }
    });
    timer_.mark(csr ? "csr_single_pass" : "ll_single_pass");
  } else {
  parallel_blocks(nblocks, max_threads, [&](int64_t blk, int th) {
    int64_t bs = blk * block_size;
    int64_t be = std::min(bs + block_size, n_loci);
    std::vector<uint8_t>& seen_short = thread_seen[(size_t)th];
    std::vector<int32_t>& distinct_short = thread_distinct[(size_t)th];
    std::vector<int64_t> members;
    block_reads(blk, members);
    for (int64_t i : members) {
      int64_t r = sel[(size_t)i];
      auto [lo, hi] = read_rows[(size_t)i];
      const uint8_t* kinds = ev_kind + ev_off[r];
      const uint8_t* bases = ev_base + ev_off[r];
      const uint8_t* quals = ev_qual + ev_off[r];
      const uint8_t* mdr = ev_mdref + ev_off[r];
      bool positive = (flags[r] & 0x10) == 0;
      auto sp_it = special_by_read.find(r);
      for (int64_t row = std::max(lo, bs); row < std::min(hi, be); row++) {
        int32_t slot = fill[row]++;
        if (slot >= D) {
          // The grids cap the depth axis.
          t->overflow[row] = 1;
          continue;
        }
        int64_t off = loci[row] - start[r];
        int64_t cell = row * D + slot;
        uint8_t kind = kinds[off];
        int32_t code;
        uint8_t rb = t->ref_base[row];
        switch (kind) {
          case EV_BASE:
            code = 0x10000 | ((int32_t)rb << 8) | bases[off];
            break;
          case EV_MID_DELETION:
            code = 0x20000 | mdr[off];
            break;
          case EV_CLIPPED:
            code = 0x30000;
            break;
          default: {  // INSERTION or DELETION anchor
            AlleleKey key;
            if (sp_it != special_by_read.end()) {
              auto it = sp_it->second.find(off);
              if (it != sp_it->second.end()) {
                int64_t s = it->second;
                std::string payload(
                    reinterpret_cast<const char*>(special_payload +
                                                  sp_payload_offset[s]),
                    sp_payload_len[s]);
                if (sp_kind[s] == EV_INSERTION) {
                  key.ref = payload.substr(0, 1);
                  key.alt = payload;
                } else {
                  key.ref = std::string(1, (char)rb) + payload;
                  key.alt = key.ref.substr(0, 1);
                }
              }
            }
            int32_t id;
            {
              std::lock_guard<std::mutex> lock(long_key_mu);
              auto found = long_key_ids.find(key);
              if (found == long_key_ids.end()) {
                id = (int32_t)long_keys.size();
                long_keys.push_back(key);
                long_key_ids[key] = id;
              } else {
                id = found->second;
              }
            }
            code = 0x40000 + id;
            break;
          }
        }
        elem_code[cell] = code;
        if (code < 0x40000 && !seen_short[code]) {
          seen_short[code] = 1;
          distinct_short.push_back(code);
        }
        t->qual[cell] = quals[off];
        t->mapq[cell] = (int16_t)mapq[r];
        t->strand[cell] = positive ? 1 : 0;
        t->mismatches[cell] = (int16_t)mismatches[r];
        t->edge[cell] = positive ? (int32_t)(end[r] - loci[row])
                                 : (int32_t)(loci[row] - start[r]);
        t->read_index[cell] = (int32_t)r;
        t->valid[cell] = 1;
      }
    }
  });
  timer_.mark("pass3_fill");
  }
  // Global key table: decode every distinct code to its byte-pair key and
  // sort (rank order == Allele ordering).
  auto decode = [&](int32_t code) -> AlleleKey {
    AlleleKey k;
    if ((code & 0x70000) == 0x10000) {
      k.ref = std::string(1, (char)((code >> 8) & 0xff));
      k.alt = std::string(1, (char)(code & 0xff));
    } else if ((code & 0x70000) == 0x20000) {
      k.ref = std::string(1, (char)(code & 0xff));
      k.alt = "";
    } else if ((code & 0x70000) == 0x30000) {
      k.ref = "";
      k.alt = "";
    } else {
      k = long_keys[code - 0x40000];
    }
    return k;
  };

  // Merge the per-thread distinct short codes, then append every long
  // code (each interned long key is used by construction).
  int64_t code_space = 0x40000 + (int64_t)long_keys.size();
  std::vector<int32_t> distinct_codes;
  if (pass3_threads == 1) {
    distinct_codes = std::move(thread_distinct[0]);
  } else {
    std::vector<uint8_t> merged(0x40000, 0);
    for (auto& local : thread_distinct)
      for (int32_t code : local)
        if (!merged[code]) {
          merged[code] = 1;
          distinct_codes.push_back(code);
        }
  }
  for (int64_t i = 0; i < (int64_t)long_keys.size(); i++)
    distinct_codes.push_back((int32_t)(0x40000 + i));
  std::vector<std::pair<AlleleKey, int32_t>> keyed;
  keyed.reserve(distinct_codes.size());
  for (int32_t code : distinct_codes) keyed.push_back({decode(code), code});
  // Ties (equal decoded keys from different codes) break by code so the
  // global rank order is deterministic AND matches the per-locus sorted
  // order of the CSR single pass.
  std::sort(keyed.begin(), keyed.end(),
            [](const auto& a, const auto& b) {
              if (a.first < b.first) return true;
              if (b.first < a.first) return false;
              return a.second < b.second;
            });
  // Flat code -> sorted rank table (O(1) per-element lookups below).
  std::vector<int32_t> code_to_rank((size_t)code_space, -1);
  t->key_ref_off.push_back(0);
  for (size_t i = 0; i < keyed.size(); i++) {
    code_to_rank[keyed[i].second] = (int32_t)i;
    const AlleleKey& k = keyed[i].first;
    t->key_blob.insert(t->key_blob.end(), k.ref.begin(), k.ref.end());
    t->key_alt_off.push_back((int64_t)t->key_blob.size());
    t->key_blob.insert(t->key_blob.end(), k.alt.begin(), k.alt.end());
    t->key_ref_off.push_back((int64_t)t->key_blob.size());
  }

  timer_.mark("key_table");
  // Pass 4 (full mode only — the single pass already assigned ids):
  // per-locus dense allele ids + uniq table + variant flags (parallel
  // over blocks with per-block uniq buffers, stitched serially).
  int64_t n_keys = (int64_t)keyed.size();
  if (full) {
  // Distinct ranks per locus are found by marking a per-thread [n_keys]
  // scratch (reset row-by-row via the touched list) instead of sorting all
  // dn element ranks: O(dn + distinct*log distinct) per row instead of
  // O(dn log dn) — the distinct-allele count is tiny (~ploidy + errors)
  // while dn is the full read depth. Scratch lives for the whole pass
  // (one allocation per thread, not per block).
  int pass4_threads = thread_count(nblocks, max_threads);
  std::vector<std::vector<uint8_t>> pass4_mark(
      (size_t)pass4_threads, std::vector<uint8_t>((size_t)n_keys, 0));
  std::vector<std::vector<int32_t>> pass4_rank2id(
      (size_t)pass4_threads, std::vector<int32_t>((size_t)n_keys, -1));
  parallel_blocks(nblocks, max_threads, [&](int64_t blk, int th) {
    int64_t bs = blk * block_size;
    int64_t be = std::min(bs + block_size, n_loci);
    auto& uniq = block_uniq[(size_t)blk];
    zero_rows(bs, be);
    std::vector<uint8_t>& mark = pass4_mark[(size_t)th];
    std::vector<int32_t>& rank2id = pass4_rank2id[(size_t)th];
    std::vector<int32_t> locus_ranks;
    for (int64_t row = bs; row < be; row++) {
      locus_ranks.clear();
      int32_t dn = (int32_t)std::min<int64_t>(t->depth[row], D);
      int64_t cell_base = row * D;
      for (int32_t slot = 0; slot < dn; slot++) {
        int32_t code = elem_code[cell_base + slot];
        if (code >= 0) {
          int32_t rank = code_to_rank[code];
          if (!mark[rank]) {
            mark[rank] = 1;
            locus_ranks.push_back(rank);
          }
        }
      }
      std::sort(locus_ranks.begin(), locus_ranks.end());
      int64_t n_distinct = (int64_t)locus_ranks.size();
      if (n_distinct > K) t->overflow[row] = 1;
      t->num_alleles[row] = (int16_t)std::min<int64_t>(n_distinct, K);
      for (int64_t u = 0; u < n_distinct; u++) {
        uniq.push_back(locus_ranks[u]);
        rank2id[locus_ranks[u]] = (int32_t)u;
        if (u < K) {
          const AlleleKey& k = keyed[locus_ranks[u]].first;
          t->is_variant[row * K + u] = (k.ref != k.alt) ? 1 : 0;
          bool std_alt = true;
          for (char c : k.alt)
            if (!is_standard((uint8_t)c)) std_alt = false;
          t->is_standard_alt[row * K + u] = std_alt ? 1 : 0;
        }
      }
      t->uniq_off[row + 1] = n_distinct;  // summed by the stitch
      // assign dense allele ids to the elements of this locus (and patch
      // the 4-bit ids into the nibble transfer row)
      uint8_t* nib_row =
          emit_nib ? t->packed_nib.data() + row * Dp : nullptr;
      for (int32_t slot = 0; slot < dn; slot++) {
        int64_t cell = cell_base + slot;
        int32_t code = elem_code[cell];
        if (code < 0) {
          t->allele_id[cell] = -1;
          continue;
        }
        int32_t rank = code_to_rank[code];
        int64_t id = rank2id[rank];
        if (id < K) {
          t->allele_id[cell] = (int16_t)id;
          if (nib_row != nullptr) {
            int shift = (slot & 1) * 4;
            nib_row[slot >> 1] = (uint8_t)((nib_row[slot >> 1] &
                                            ~(0xF << shift)) |
                                           ((int)id << shift));
          }
        } else {
          // beyond the cap: invalidate the slot (matches the Python packers)
          t->allele_id[cell] = -1;
          t->valid[cell] = 0;
          t->qual[cell] = 0;
          t->mapq[cell] = 0;
          t->strand[cell] = 0;
          t->mismatches[cell] = 0;
          t->edge[cell] = 0;
          t->read_index[cell] = -1;
        }
      }
      for (int32_t rank : locus_ranks) {
        mark[rank] = 0;
        rank2id[rank] = -1;
      }
    }
  });
  timer_.mark("pass4_ids");
  }  // full
  // Stitch per-block uniq tables into the global values, and each row's
  // count of alleles into offsets. The single pass recorded raw codes —
  // remap them to global sorted ranks here.
  int64_t total_uniq = 0;
  for (auto& u : block_uniq) total_uniq += (int64_t)u.size();
  t->uniq_key.resize((size_t)total_uniq);
  int32_t* uniq_out = t->uniq_key.data();
  for (auto& u : block_uniq)
    for (int32_t v : u) *uniq_out++ = full ? v : code_to_rank[v];
  for (int64_t row = 0; row < n_loci; row++)
    t->uniq_off[row + 1] += t->uniq_off[row];
  // Sentinel rows (L padding) keep the last offset.
  std::fill(t->uniq_off.begin() + n_loci + 1, t->uniq_off.end(), total_uniq);

  timer_.mark("stitch");

  if (ll) {
    // Qual-dictionary transcode (see PackedTile::ll_pack8): the sweep
    // marked the distinct qual fields it wrote, and when <= 16 exist, the
    // encoding is rewritten at one byte per element.
    std::vector<uint8_t> quals;
    for (int q = 0; q < 256; q++)
      for (const auto& seen : thread_qseen)
        if (seen[q >> 6] >> (q & 63) & 1) {
          quals.push_back((uint8_t)q);
          break;
        }
    if (!quals.empty() && quals.size() <= 16) {
      uint8_t idx_of[256];
      for (size_t u = 0; u < quals.size(); u++)
        idx_of[quals[u]] = (uint8_t)u;
      t->ll_qvals = quals;
      size_t n_cells = t->ll_pack.size();
      int64_t qblocks =
          std::max<int64_t>(1, (int64_t)(n_cells + (1 << 20) - 1) >> 20);
      t->ll_pack8.resize(n_cells);
      parallel_blocks(qblocks, max_threads, [&](int64_t b, int) {
        size_t lo = (size_t)b << 20;
        size_t hi = std::min(n_cells, lo + (1 << 20));
        for (size_t i = lo; i < hi; i++) {
          uint16_t v = t->ll_pack[i];
          t->ll_pack8[i] =
              v == 0xFFFF
                  ? (uint8_t)0xFF
                  : (uint8_t)((v & 0xF) | (idx_of[v >> 4] << 4));
        }
      });
    }
    timer_.mark("ll_qdict");
  }
  return t;
}

void guac_free_tile(void* handle) { delete static_cast<PackedTile*>(handle); }

int64_t guac_tile_L(void* h) { return static_cast<PackedTile*>(h)->L; }
int64_t guac_tile_D(void* h) { return static_cast<PackedTile*>(h)->D; }

#define TILE_ACCESSOR(name, field, ctype)                  \
  const ctype* guac_tile_##name(void* h, int64_t* n) {     \
    PackedTile* t = static_cast<PackedTile*>(h);           \
    *n = (int64_t)t->field.size();                         \
    return t->field.data();                                \
  }

TILE_ACCESSOR(ref_base, ref_base, uint8_t)
TILE_ACCESSOR(depth, depth, int32_t)
TILE_ACCESSOR(num_alleles, num_alleles, int16_t)
TILE_ACCESSOR(overflow, overflow, uint8_t)
TILE_ACCESSOR(allele_id, allele_id, int16_t)
TILE_ACCESSOR(qual, qual, int16_t)
TILE_ACCESSOR(mapq, mapq, int16_t)
TILE_ACCESSOR(strand, strand, uint8_t)
TILE_ACCESSOR(mismatches, mismatches, int16_t)
TILE_ACCESSOR(edge, edge, int32_t)
TILE_ACCESSOR(read_index, read_index, int32_t)
TILE_ACCESSOR(valid, valid, uint8_t)
TILE_ACCESSOR(packed_nib, packed_nib, uint8_t)
TILE_ACCESSOR(csr_nib, csr_nib, uint8_t)
TILE_ACCESSOR(csr_off, csr_off, int32_t)
TILE_ACCESSOR(ll_pack, ll_pack, uint16_t)
TILE_ACCESSOR(ll_pack8, ll_pack8, uint8_t)
TILE_ACCESSOR(ll_qvals, ll_qvals, uint8_t)
TILE_ACCESSOR(ll_mapq, ll_mapq, uint8_t)
TILE_ACCESSOR(is_variant, is_variant, uint8_t)
TILE_ACCESSOR(is_standard_alt, is_standard_alt, uint8_t)
TILE_ACCESSOR(counts, counts, int32_t)
TILE_ACCESSOR(ll_candidates, ll_candidates, uint8_t)
TILE_ACCESSOR(key_blob, key_blob, uint8_t)
TILE_ACCESSOR(key_ref_off, key_ref_off, int64_t)
TILE_ACCESSOR(key_alt_off, key_alt_off, int64_t)
TILE_ACCESSOR(uniq_key, uniq_key, int32_t)
TILE_ACCESSOR(uniq_off, uniq_off, int64_t)

// ---------------------------------------------------------------------------
// Covered-loci computation: the loci of the given ranges covered by >= 1
// read, as one sorted int64 array (the native form of
// pack/columnar.py::covered_loci — a whole-region call costs ~ms where the
// Python interval merge + arange materialization costs ~seconds).
// ---------------------------------------------------------------------------

struct CoveredLoci {
  raw_vector<int64_t> loci;
};

void* guac_covered_loci(
    int64_t n_reads, const int32_t* ref_id, const int64_t* start,
    const int64_t* end, int32_t contig_id,
    int64_t n_ranges, const int64_t* range_lo, const int64_t* range_hi,
    // Optional read-index scan window (see guac_pack_tile); hi <= 0 means
    // "scan everything".
    int64_t scan_lo, int64_t scan_hi) {
  int64_t r_begin = 0, r_end = n_reads;
  if (scan_hi > 0) {
    r_begin = std::max<int64_t>(0, std::min(scan_lo, n_reads));
    r_end = std::max(r_begin, std::min(scan_hi, n_reads));
  }
  std::vector<std::pair<int64_t, int64_t>> iv;
  iv.reserve(1024);
  bool sorted = true;
  int64_t prev = INT64_MIN;
  for (int64_t r = r_begin; r < r_end; r++) {
    if (ref_id[r] != contig_id) continue;
    if (end[r] <= start[r]) continue;
    iv.push_back({start[r], end[r]});
    if (start[r] < prev) sorted = false;
    prev = start[r];
  }
  CoveredLoci* out = new CoveredLoci();
  if (iv.empty() || n_ranges == 0) return out;
  if (!sorted) std::sort(iv.begin(), iv.end());
  // Merge into maximal covered intervals.
  std::vector<std::pair<int64_t, int64_t>> merged;
  merged.reserve(iv.size());
  int64_t cs = iv[0].first, ce = iv[0].second;
  for (size_t i = 1; i < iv.size(); i++) {
    if (iv[i].first > ce) {
      merged.push_back({cs, ce});
      cs = iv[i].first;
      ce = iv[i].second;
    } else {
      ce = std::max(ce, iv[i].second);
    }
  }
  merged.push_back({cs, ce});
  // Intersect with the (sorted, disjoint) loci ranges and size the output.
  int64_t total = 0;
  size_t ci = 0;
  for (int64_t g = 0; g < n_ranges; g++) {
    int64_t s = range_lo[g], e = range_hi[g];
    while (ci < merged.size() && merged[ci].second <= s) ci++;
    for (size_t cj = ci; cj < merged.size() && merged[cj].first < e; cj++) {
      int64_t lo = std::max(s, merged[cj].first);
      int64_t hi = std::min(e, merged[cj].second);
      if (hi > lo) total += hi - lo;
    }
  }
  out->loci.resize((size_t)total);
  int64_t w = 0;
  ci = 0;
  for (int64_t g = 0; g < n_ranges; g++) {
    int64_t s = range_lo[g], e = range_hi[g];
    while (ci < merged.size() && merged[ci].second <= s) ci++;
    for (size_t cj = ci; cj < merged.size() && merged[cj].first < e; cj++) {
      int64_t lo = std::max(s, merged[cj].first);
      int64_t hi = std::min(e, merged[cj].second);
      for (int64_t x = lo; x < hi; x++) out->loci[(size_t)w++] = x;
    }
  }
  return out;
}

void guac_free_covered(void* handle) {
  delete static_cast<CoveredLoci*>(handle);
}

// In-place per-row normalization of genotype log-likelihoods — the
// native twin of likelihood.py::_normalization_log_total + subtraction
// (called per candidate row in the exact confirm; the Python loop costs
// ~8 us x 137k rows at scale). Bit-identical by construction: same libm
// exp/log calls (Python's math.exp/math.log are these), same sequential
// accumulation order, same -700 precision floor and logsumexp fallback
// (DEVIATIONS.md #11).
void guac_normalize_ll_rows(double* lls, const int64_t* row_off,
                            int64_t n_rows) {
  const double kFloor = -700.0;
  for (int64_t r = 0; r < n_rows; r++) {
    int64_t lo = row_off[r], hi = row_off[r + 1];
    if (hi <= lo) continue;
    double m = -INFINITY;
    for (int64_t i = lo; i < hi; i++)
      if (lls[i] > m) m = lls[i];
    double norm;
    if (m > kFloor) {
      double total = 0.0;
      for (int64_t i = lo; i < hi; i++) total += exp(lls[i]);
      norm = total > 0.0 ? log(total) : -INFINITY;
    } else if (!std::isfinite(m)) {
      norm = -INFINITY;
    } else {
      double shifted = 0.0;
      for (int64_t i = lo; i < hi; i++) shifted += exp(lls[i] - m);
      norm = m + log(shifted);
    }
    for (int64_t i = lo; i < hi; i++) lls[i] -= norm;
  }
}

// The candidate rule over [L, K] counts (numpy twin: ops/dispatch.py::
// host_counts_candidates; device twin: ops/kernels.py::counts_candidates).
// threshold < 0 means "no threshold" (any variant allele with evidence).
// Writes L bytes of 0/1 into out_mask. One linear pass, no temporaries —
// the numpy form allocates several [L, K] intermediates (~GBs at 9M loci).
void guac_counts_screen(
    const int32_t* counts, const uint8_t* is_variant, int64_t L, int64_t K,
    int64_t threshold, uint8_t* out_mask) {
  for (int64_t r = 0; r < L; r++) {
    const int32_t* row = counts + r * K;
    const uint8_t* iv = is_variant + r * K;
    uint8_t cand = 0;
    if (threshold < 0) {
      for (int64_t k = 0; k < K; k++)
        if (row[k] > 0 && iv[k]) {
          cand = 1;
          break;
        }
    } else {
      int64_t depth = 0;
      for (int64_t k = 0; k < K; k++) depth += row[k];
      int64_t bar = depth * (threshold + 1);
      int ref_passing = 0;
      for (int64_t k = 0; k < K; k++) {
        if (row[k] > 0 && (int64_t)row[k] * 100 >= bar) {
          if (iv[k]) {
            cand = 1;
            break;
          }
          if (++ref_passing >= 2) {
            cand = 1;
            break;
          }
        }
      }
    }
    out_mask[r] = cand;
  }
}

const int64_t* guac_covered_data(void* handle, int64_t* n) {
  CoveredLoci* c = static_cast<CoveredLoci*>(handle);
  *n = (int64_t)c->loci.size();
  return c->loci.data();
}

}  // extern "C"
