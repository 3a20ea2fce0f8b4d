// Drives the tile packer of the port's native host runtime
// (guacamole_tpu_torch/runtime/csrc/) over a BAM, for
// tests/test_torch_native.py, which builds it with -fsanitize=thread.
//
//   native_pack_harness BAM ROUNDS
//
// Decodes BAM with guac_decode_bam, then packs every position of each of
// its contigs ROUNDS times as the counting and likelihood screens take it
// (mode 1, CSR: the packer's threads each own a block of rows and intern
// the long allele keys of insertions and deletions into one shared
// table), with the germline likelihood screen on. Prints one line per
// contig: its name, its rows and the sum of the screen's candidate flags,
// which every round must repeat.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {
void* guac_decode_bam(const char* path, int threads);
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
COLUMN(ev_off, int64_t)
COLUMN(ev_kind, uint8_t)
COLUMN(ev_base, uint8_t)
COLUMN(ev_qual, uint8_t)
COLUMN(ev_mdref, uint8_t)
COLUMN(special_payload, uint8_t)
COLUMN(tile_ll_candidates, uint8_t)
#undef COLUMN
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
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: %s BAM ROUNDS\n", argv[0]);
    return 2;
  }
  void* reads = guac_decode_bam(argv[1], 2);
  if (reads == nullptr) return 3;
  int rounds = atoi(argv[2]);
  int64_t n = guac_num_reads(reads), unused;
  int64_t n_sp = guac_num_specials(reads);
  std::vector<int64_t> sp_read(n_sp), sp_offset(n_sp), sp_poff(n_sp),
      sp_plen(n_sp);
  std::vector<int32_t> sp_kind(n_sp), sp_qual(n_sp);
  guac_specials(reads, sp_read.data(), sp_offset.data(), sp_kind.data(),
                sp_poff.data(), sp_plen.data(), sp_qual.data());
  for (int64_t c = 0; c < guac_num_refs(reads); c++) {
    std::vector<int64_t> loci(guac_ref_length(reads, c));
    for (size_t i = 0; i < loci.size(); i++) loci[i] = (int64_t)i;
    long long first = -1;
    for (int round = 0; round < rounds; round++) {
      void* tile = guac_pack_tile(
          n, guac_ref_id(reads, &unused), guac_start(reads, &unused),
          guac_end(reads, &unused), guac_mapq(reads, &unused),
          guac_flags(reads, &unused), guac_mismatches(reads, &unused),
          guac_ev_off(reads, &unused), guac_ev_kind(reads, &unused),
          guac_ev_base(reads, &unused), guac_ev_qual(reads, &unused),
          guac_ev_mdref(reads, &unused), n_sp, sp_read.data(),
          sp_offset.data(), sp_kind.data(), sp_poff.data(), sp_plen.data(),
          sp_qual.data(), guac_special_payload(reads, &unused), (int32_t)c,
          (int64_t)loci.size(), loci.data(), /*K=*/8, /*depth_pad=*/0,
          /*l_pad=*/0, /*mode=*/1, /*min_mapq=*/0, nullptr, 0, 0, 0,
          /*ll_screen_margin=*/4.0, /*ll_screen_kind=*/1,
          /*skip_nibbles=*/0, /*ll_screen_min_phred=*/0.0);
      if (tile == nullptr) return 4;
      int64_t L = guac_tile_L(tile), n_flags = 0;
      const uint8_t* flags = guac_tile_ll_candidates(tile, &n_flags);
      long long sum = 0;
      for (int64_t i = 0; i < n_flags; i++) sum += flags[i];
      guac_free_tile(tile);
      if (round == 0) {
        first = sum;
        printf("%s %lld %lld\n", guac_ref_name(reads, c), (long long)L, sum);
      } else if (sum != first) {
        return 5;
      }
    }
  }
  guac_free_reads(reads);
  return 0;
}
