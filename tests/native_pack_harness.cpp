// Drives the tile packer and the event builder of the port's native host
// runtime (guacamole_tpu_torch/runtime/csrc/) over a BAM, for
// tests/test_torch_native.py and chip_smoke.py, which build it with
// -fsanitize=thread.
//
//   native_pack_harness BAM ROUNDS [MODES [WINDOW [WINDOWS [THREADS [START
//                       [PAD [MIN_MAPQ]]]]]]]
//   native_pack_harness BAM ROUNDS events [THREADS]
//   native_pack_harness BAM ROUNDS chunks THREADS VBEG VEND [VBEG VEND]...
//
// Decodes BAM with guac_decode_bam (on THREADS threads, default 2). For
// each mode of the comma-separated list MODES (default 1) it packs each
// of its contigs ROUNDS times in windows of WINDOW consecutive loci (0,
// the default: the whole contig in one call), the first WINDOWS windows
// (0, the default: all) from locus START (default 0) of each contig that
// reaches past START, on THREADS packer threads
// (GUAC_PACK_THREADS; default: the packer's own choice), each tile with
// PAD sentinel rows past its loci (l_pad; default 0) and the elements of
// reads under MIN_MAPQ filtered (default 0: none). The modes are
// guac_pack_tile's: 0 full [L, D] tiles (the dense route), 1 CSR for the
// counting screens with the germline likelihood screen on (each thread
// owns a block of rows and interns the long allele keys of insertions and
// deletions into one shared table), 2 dense likelihood tiles, 3 dense
// likelihood tiles with the MAPQ plane (the tumor screen). Prints one
// line per mode and contig: the mode, the contig's name, its rows, its
// windows, a checksum of the tiles' outputs, which every round must
// repeat, and the sum of the likelihood screen's candidate flags (mode 1
// fills them); on stderr, `pack mode M` before a mode's packs and
// `pack mode M: S s` after them.
//
// With `events` it rebuilds the decoded reads' event arrays with
// guac_build_events on THREADS threads (default 16), ROUNDS times, and
// prints one line: `events`, the reads, the events and the specials; the
// arrays must equal the decoder's own every time.
//
// With `chunks` it decodes the chunk list VBEG VEND ... (BGZF virtual
// offsets, begin and end of each chunk in turn) with guac_decode_bam_chunks
// on THREADS threads, ROUNDS times, and prints one line: `chunks`, the
// reads, the events and the specials; every round must decode the same
// columns.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* guac_decode_bam(const char* path, int threads);
void* guac_decode_bam_chunks(const char* path, int threads, int64_t n_chunks,
                             const int64_t* vbeg, const int64_t* vend);
const char* guac_last_error();
int64_t guac_num_reads(void* h);
int64_t guac_num_refs(void* h);
const char* guac_ref_name(void* h, int64_t i);
int64_t guac_ref_length(void* h, int64_t i);
int64_t guac_num_specials(void* h);
void guac_specials(void* h, int64_t* sp_read, int64_t* sp_offset,
                   int32_t* sp_kind, int64_t* sp_payload_offset,
                   int64_t* sp_payload_len, int32_t* sp_qual);
void guac_free_reads(void* h);
#define COLUMN(name, ctype) const ctype* guac_##name(void* h, int64_t* n);
COLUMN(ref_id, int32_t)
COLUMN(start, int64_t)
COLUMN(end, int64_t)
COLUMN(mapq, int32_t)
COLUMN(flags, uint16_t)
COLUMN(mismatches, int32_t)
COLUMN(seq_off, int64_t)
COLUMN(seq, uint8_t)
COLUMN(qual, uint8_t)
COLUMN(cigar_off, int64_t)
COLUMN(cigar_len, uint32_t)
COLUMN(cigar_op, uint8_t)
COLUMN(md_off, int64_t)
COLUMN(md_text, uint8_t)
COLUMN(ev_off, int64_t)
COLUMN(ev_kind, uint8_t)
COLUMN(ev_base, uint8_t)
COLUMN(ev_qual, uint8_t)
COLUMN(ev_mdref, uint8_t)
COLUMN(special_payload, uint8_t)
#undef COLUMN
void* guac_build_events(int64_t n, const int64_t* start, const int32_t* mapq,
                        const int64_t* seq_off, const uint8_t* seq,
                        const uint8_t* qual, const int64_t* cigar_off,
                        const uint32_t* cigar_len, const uint8_t* cigar_op,
                        const int64_t* md_off, const uint8_t* md_text,
                        const int64_t* ev_off, int threads, uint8_t* ev_kind,
                        uint8_t* ev_base, uint8_t* ev_qual, uint8_t* ev_mdref,
                        int32_t* mismatches);
void* guac_pack_tile(
    int64_t n_reads, const int32_t* ref_id, const int64_t* start,
    const int64_t* end, const int32_t* mapq, const uint16_t* flags,
    const int32_t* mismatches, const int64_t* ev_off, const uint8_t* ev_kind,
    const uint8_t* ev_base, const uint8_t* ev_qual, const uint8_t* ev_mdref,
    int64_t n_specials, const int64_t* sp_read, const int64_t* sp_offset,
    const int32_t* sp_kind, const int64_t* sp_payload_offset,
    const int64_t* sp_payload_len, const int32_t* sp_qual,
    const uint8_t* special_payload, int32_t contig_id, int64_t n_loci,
    const int64_t* loci, int64_t K, int64_t depth_pad, int64_t l_pad,
    int64_t mode, int64_t min_mapq, const uint8_t* ref_contig,
    int64_t ref_contig_len, int64_t scan_lo, int64_t scan_hi,
    double ll_screen_margin, int64_t ll_screen_kind, int64_t skip_nibbles,
    double ll_screen_min_phred);
int64_t guac_tile_L(void* t);
void guac_free_tile(void* t);
#define TILE(name) const void* guac_tile_##name(void* t, int64_t* n);
TILE(depth)
TILE(ll_candidates)
TILE(csr_off)
TILE(ll_pack)
TILE(ll_pack8)
TILE(ll_mapq)
TILE(is_variant)
TILE(allele_id)
#undef TILE
}

template <class T>
static const T* column(const T* (*fn)(void*, int64_t*), void* reads) {
  int64_t unused;
  return fn(reads, &unused);
}

// A sum of every byte of the outputs the modes fill (each mode leaves
// the others empty), weighted by position so a moved byte shows.
static unsigned long long checksum(void* tile) {
  const void* (*outputs[])(void*, int64_t*) = {
      guac_tile_depth,   guac_tile_ll_candidates, guac_tile_csr_off,
      guac_tile_ll_pack, guac_tile_ll_pack8,      guac_tile_ll_mapq,
      guac_tile_is_variant, guac_tile_allele_id};
  const int64_t sizes[] = {4, 1, 4, 2, 1, 1, 1, 2};
  unsigned long long sum = 0;
  for (int k = 0; k < 8; k++) {
    int64_t n = 0;
    const uint8_t* p = static_cast<const uint8_t*>(outputs[k](tile, &n));
    for (int64_t i = 0; i < n * sizes[k]; i++)
      sum += (unsigned long long)p[i] * (uint64_t)(i % 251 + 1);
  }
  return sum;
}

// The sum of the likelihood screen's candidate flags of a tile.
static long long candidates(void* tile) {
  int64_t n = 0;
  const uint8_t* flags =
      static_cast<const uint8_t*>(guac_tile_ll_candidates(tile, &n));
  long long sum = 0;
  for (int64_t i = 0; i < n; i++) sum += flags[i];
  return sum;
}

static int pack(void* reads, int rounds, int mode, int64_t window,
                int64_t max_windows, int64_t start, int64_t pad,
                int64_t min_mapq) {
  int64_t n = guac_num_reads(reads), n_sp = guac_num_specials(reads);
  std::vector<int64_t> sp_read(n_sp), sp_offset(n_sp), sp_poff(n_sp),
      sp_plen(n_sp);
  std::vector<int32_t> sp_kind(n_sp), sp_qual(n_sp);
  guac_specials(reads, sp_read.data(), sp_offset.data(), sp_kind.data(),
                sp_poff.data(), sp_plen.data(), sp_qual.data());
  for (int64_t c = 0; c < guac_num_refs(reads); c++) {
    int64_t length = guac_ref_length(reads, c);
    if (start >= length) continue;
    int64_t step = window > 0 ? window : length - start;
    unsigned long long first = 0;
    for (int round = 0; round < rounds; round++) {
      unsigned long long sum = 0;
      long long rows = 0, windows = 0, flags = 0;
      for (int64_t lo = start; lo < length; lo += step) {
        if (max_windows > 0 && windows == max_windows) break;
        int64_t hi = lo + step < length ? lo + step : length;
        std::vector<int64_t> loci(hi - lo);
        for (size_t i = 0; i < loci.size(); i++) loci[i] = lo + (int64_t)i;
        void* tile = guac_pack_tile(
            n, column(guac_ref_id, reads), column(guac_start, reads),
            column(guac_end, reads), column(guac_mapq, reads),
            column(guac_flags, reads), column(guac_mismatches, reads),
            column(guac_ev_off, reads), column(guac_ev_kind, reads),
            column(guac_ev_base, reads), column(guac_ev_qual, reads),
            column(guac_ev_mdref, reads), n_sp, sp_read.data(),
            sp_offset.data(), sp_kind.data(), sp_poff.data(), sp_plen.data(),
            sp_qual.data(), column(guac_special_payload, reads), (int32_t)c,
            (int64_t)loci.size(), loci.data(), /*K=*/8, /*depth_pad=*/0,
            /*l_pad=*/pad > 0 ? (int64_t)loci.size() + pad : 0, mode,
            min_mapq, nullptr, 0, 0, 0,
            /*ll_screen_margin=*/mode == 1 ? 4.0 : 0.0,
            /*ll_screen_kind=*/mode == 3 ? 2 : 1,
            /*skip_nibbles=*/0, /*ll_screen_min_phred=*/0.0);
        if (tile == nullptr) return 4;
        rows += guac_tile_L(tile);
        windows++;
        sum += checksum(tile);
        flags += candidates(tile);
        guac_free_tile(tile);
      }
      if (round == 0) {
        first = sum;
        printf("%d %s %lld %lld %llu %lld\n", mode, guac_ref_name(reads, c),
               rows, windows, sum, flags);
      } else if (sum != first) {
        return 5;
      }
    }
  }
  return 0;
}

static int events(void* reads, int rounds, int threads) {
  int64_t n = guac_num_reads(reads);
  const int64_t* ev_off = column(guac_ev_off, reads);
  int64_t total = ev_off[n];
  std::vector<uint8_t> kind(total), base(total), qual(total), mdref(total);
  std::vector<int32_t> mismatches(n);
  long long n_specials = guac_num_specials(reads);
  for (int round = 0; round < rounds; round++) {
    void* out = guac_build_events(
        n, column(guac_start, reads), column(guac_mapq, reads),
        column(guac_seq_off, reads), column(guac_seq, reads),
        column(guac_qual, reads), column(guac_cigar_off, reads),
        column(guac_cigar_len, reads), column(guac_cigar_op, reads),
        column(guac_md_off, reads), column(guac_md_text, reads), ev_off,
        threads, kind.data(), base.data(), qual.data(), mdref.data(),
        mismatches.data());
    if (out == nullptr) return 4;
    bool same_specials = guac_num_specials(out) == n_specials;
    guac_free_reads(out);
    if (!same_specials ||
        memcmp(kind.data(), column(guac_ev_kind, reads), total) != 0 ||
        memcmp(base.data(), column(guac_ev_base, reads), total) != 0 ||
        memcmp(qual.data(), column(guac_ev_qual, reads), total) != 0 ||
        memcmp(mdref.data(), column(guac_ev_mdref, reads), total) != 0 ||
        memcmp(mismatches.data(), column(guac_mismatches, reads),
               n * sizeof(int32_t)) != 0)
      return 5;
  }
  printf("events %lld %lld %lld\n", (long long)n, (long long)total,
         n_specials);
  return 0;
}

// A sum of every byte of a decode's columns and specials, weighted by
// position so a moved byte shows.
static unsigned long long decode_checksum(void* reads) {
  const uint8_t* (*bytes[])(void*, int64_t*) = {
      guac_seq,     guac_qual,    guac_cigar_op, guac_md_text,
      guac_ev_kind, guac_ev_base, guac_ev_qual,  guac_ev_mdref,
      guac_special_payload};
  unsigned long long sum = 0;
  for (auto column_of : bytes) {
    int64_t n = 0;
    const uint8_t* p = column_of(reads, &n);
    for (int64_t i = 0; i < n; i++)
      sum = sum * 31 + (unsigned long long)p[i] * (uint64_t)(i % 251 + 1);
  }
  int64_t n = 0;
  const int64_t* starts = guac_start(reads, &n);
  const int32_t* mismatches = guac_mismatches(reads, &n);
  for (int64_t i = 0; i < n; i++)
    sum = sum * 31 + (unsigned long long)starts[i] + (uint32_t)mismatches[i];
  const uint32_t* cigar_len = guac_cigar_len(reads, &n);
  for (int64_t i = 0; i < n; i++) sum = sum * 31 + cigar_len[i];
  return sum;
}

static int chunks(const char* path, int rounds, int threads,
                  const std::vector<int64_t>& vbeg,
                  const std::vector<int64_t>& vend) {
  unsigned long long first = 0;
  for (int round = 0; round < rounds; round++) {
    void* reads = guac_decode_bam_chunks(path, threads, (int64_t)vbeg.size(),
                                         vbeg.data(), vend.data());
    if (reads == nullptr) {
      fprintf(stderr, "%s: %s\n", path, guac_last_error());
      return 3;
    }
    unsigned long long sum = decode_checksum(reads);
    if (round == 0) {
      first = sum;
      int64_t n = guac_num_reads(reads);
      printf("chunks %lld %lld %lld\n", (long long)n,
             (long long)column(guac_ev_off, reads)[n],
             (long long)guac_num_specials(reads));
    }
    guac_free_reads(reads);
    if (sum != first) return 5;
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s BAM ROUNDS [MODES [WINDOW [WINDOWS [THREADS [START [PAD "
            "[MIN_MAPQ]]]]]]]\n"
            "       %s BAM ROUNDS events [THREADS]\n"
            "       %s BAM ROUNDS chunks THREADS VBEG VEND [VBEG VEND]...\n",
            argv[0], argv[0], argv[0]);
    return 2;
  }
  if (argc > 3 && std::string(argv[3]) == "chunks") {
    if (argc < 7 || (argc - 5) % 2 != 0) return 2;
    std::vector<int64_t> vbeg, vend;
    for (int i = 5; i + 1 < argc; i += 2) {
      vbeg.push_back(atoll(argv[i]));
      vend.push_back(atoll(argv[i + 1]));
    }
    return chunks(argv[1], atoi(argv[2]), atoi(argv[4]), vbeg, vend);
  }
  bool build_events = argc > 3 && std::string(argv[3]) == "events";
  const char* threads = build_events ? (argc > 4 ? argv[4] : "16")
                                     : (argc > 6 ? argv[6] : nullptr);
  void* reads = guac_decode_bam(argv[1], threads ? atoi(threads) : 2);
  if (reads == nullptr) {
    fprintf(stderr, "%s: %s\n", argv[1], guac_last_error());
    return 3;
  }
  int rounds = atoi(argv[2]);
  int rc = 0;
  if (build_events) {
    rc = events(reads, rounds, atoi(threads));
  } else {
    if (threads) setenv("GUAC_PACK_THREADS", threads, 1);
    std::string modes = argc > 3 ? argv[3] : "1";
    for (size_t at = 0; rc == 0 && at < modes.size();) {
      size_t comma = modes.find(',', at);
      if (comma == std::string::npos) comma = modes.size();
      int mode = atoi(modes.substr(at, comma - at).c_str());
      // Marks where each mode's sanitizer reports begin, and its time.
      fprintf(stderr, "pack mode %d\n", mode);
      auto t0 = std::chrono::steady_clock::now();
      rc = pack(reads, rounds, mode, argc > 4 ? atoll(argv[4]) : 0,
                argc > 5 ? atoll(argv[5]) : 0, argc > 7 ? atoll(argv[7]) : 0,
                argc > 8 ? atoll(argv[8]) : 0, argc > 9 ? atoll(argv[9]) : 0);
      fprintf(stderr, "pack mode %d: %.3f s\n", mode,
              std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                            t0).count());
      at = comma + 1;
    }
  }
  guac_free_reads(reads);
  return rc;
}
