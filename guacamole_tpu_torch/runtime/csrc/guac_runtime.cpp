// guac_runtime: native host runtime for guacamole_tpu_torch.
//
// Performs the host-side hot path of the TPU variant-calling pipeline:
//   1. BGZF block decompression (multithreaded, zlib)
//   2. BAM record parsing into columnar arrays
//   3. MD-tag expansion into per-read reference bases
//   4. Per-locus pileup event-array construction (the input to the
//      vectorized tile packer)
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11 in this
// build environment). All output buffers are malloc'd here and released
// with guac_free_reads().
//
// Behavioral contract matches the Python reference implementations in
// guacamole_tpu_torch/gio/bam.py and guacamole_tpu_torch/pack/events.py (cross-checked
// in tests/test_runtime.py); the event classification rules mirror the
// original pileup semantics (cf. reference
// .../pileup/PileupElement.scala:68-135).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------- utilities

// Why the last decode on this thread returned no handle, for
// guac_last_error(); empty after a decode that succeeded.
thread_local std::string g_last_error;

static std::nullptr_t decode_failed(const std::string& why) {
  g_last_error = why.empty() ? "decode failed" : why;
  return nullptr;
}

// Runs the body of a C entry: an exception (std::bad_alloc from a size
// the input gave) must not cross the C ABI, where it aborts the process.
template <class Body>
static void* guarded(Body body) {
  g_last_error.clear();
  try {
    return body();
  } catch (const std::bad_alloc&) {
    return decode_failed("out of memory");
  } catch (const std::exception& e) {
    return decode_failed(e.what());
  } catch (...) {
    return decode_failed("unknown exception");
  }
}

struct Buffer {
  std::vector<uint8_t> data;
};

static bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(size);
  size_t got = fread(out->data(), 1, size, f);
  fclose(f);
  return got == static_cast<size_t>(size);
}

// ------------------------------------------------------------- BGZF inflate

struct BgzfBlock {
  size_t coffset;    // compressed offset of block start
  size_t bsize;      // compressed block size
  size_t uoffset;    // output offset of uncompressed data
  size_t usize;      // uncompressed size
};

// A BGZF block inflates to at most 64 KiB (SAM/BAM spec 4.1); a larger
// ISIZE is corrupt input, not a size to allocate.
static const uint32_t kBgzfMaxBlock = 65536;
// The EOF marker (SAM/BAM spec 4.1.2): an empty block, the least a block
// can take.
static const uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0, 0x42, 0x43,
    2,    0,    0x1b, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// Scan block headers; returns false on malformed input.
static bool scan_bgzf_blocks(const std::vector<uint8_t>& data,
                             std::vector<BgzfBlock>* blocks,
                             size_t* total_usize) {
  size_t offset = 0;
  size_t uoffset = 0;
  const size_t n = data.size();
  while (offset + 28 <= n) {
    if (data[offset] != 0x1f || data[offset + 1] != 0x8b) return false;
    if (!(data[offset + 3] & 0x04)) return false;
    uint16_t xlen;
    memcpy(&xlen, &data[offset + 10], 2);
    // Every header walk stays inside its buffer: the extra field, each
    // subfield and the block's footer.
    if (offset + 12 + xlen > n) return false;
    size_t pos = offset + 12, end = pos + xlen;
    size_t bsize = 0;
    while (pos + 4 <= end) {
      uint8_t si1 = data[pos], si2 = data[pos + 1];
      uint16_t slen;
      memcpy(&slen, &data[pos + 2], 2);
      if (pos + 4 + slen > end) return false;
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, &data[pos + 4], 2);
        bsize = static_cast<size_t>(bs) + 1;
      }
      pos += 4 + slen;
    }
    if (bsize < 12 + (size_t)xlen + 8 || offset + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, &data[offset + bsize - 4], 4);
    if (isize > kBgzfMaxBlock) return false;
    blocks->push_back({offset, bsize, uoffset, isize});
    uoffset += isize;
    offset += bsize;
  }
  *total_usize = uoffset;
  return offset == n;
}

// libdeflate's raw-DEFLATE decoder is ~2-3x zlib's — BGZF inflate is
// the decode phase's hot loop. Resolved via dlopen at RUNTIME (not
// linked) so the shared library never carries a NEEDED dependency on
// it: hosts without libdeflate fall back to zlib transparently.
#include <dlfcn.h>
namespace {
typedef void* (*ld_alloc_fn)();
typedef int (*ld_decompress_fn)(void*, const void*, size_t, void*, size_t,
                                size_t*);
typedef void (*ld_free_fn)(void*);
struct LibdeflateApi {
  ld_alloc_fn alloc = nullptr;
  ld_decompress_fn decompress = nullptr;  // LIBDEFLATE_SUCCESS == 0
  ld_free_fn free_decomp = nullptr;
};
const LibdeflateApi& libdeflate_api() {
  static LibdeflateApi api = [] {
    LibdeflateApi a;
    void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (h == nullptr) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr) {
      a.alloc = reinterpret_cast<ld_alloc_fn>(
          dlsym(h, "libdeflate_alloc_decompressor"));
      a.decompress = reinterpret_cast<ld_decompress_fn>(
          dlsym(h, "libdeflate_deflate_decompress"));
      a.free_decomp = reinterpret_cast<ld_free_fn>(
          dlsym(h, "libdeflate_free_decompressor"));
      if (a.alloc == nullptr || a.decompress == nullptr ||
          a.free_decomp == nullptr) {
        a.alloc = nullptr;
        a.decompress = nullptr;
        a.free_decomp = nullptr;
      }
    }
    return a;
  }();
  return api;
}
// One decompressor per thread: allocation is not free and inflate_block
// runs once per 64 KiB BGZF block. Short-lived pool threads must call
// release_tl_decomp() before exiting — thread_local storage is NOT freed
// automatically for a raw pointer, and the chunked streaming decode
// spawns a pool per call (the leak would grow with input size).
thread_local void* tl_decomp = nullptr;

void release_tl_decomp() {
  if (tl_decomp != nullptr) {
    const LibdeflateApi& ld = libdeflate_api();
    if (ld.free_decomp != nullptr) ld.free_decomp(tl_decomp);
    tl_decomp = nullptr;
  }
}
}  // namespace

static bool inflate_block(const std::vector<uint8_t>& data,
                          const BgzfBlock& block, uint8_t* out) {
  if (block.usize == 0) return true;
  uint16_t xlen;
  memcpy(&xlen, &data[block.coffset + 10], 2);
  const uint8_t* cdata = &data[block.coffset + 12 + xlen];
  size_t csize = block.bsize - 12 - xlen - 8;
  const LibdeflateApi& ld = libdeflate_api();
  if (ld.alloc != nullptr) {
    if (tl_decomp == nullptr) tl_decomp = ld.alloc();
    if (tl_decomp != nullptr) {
      size_t actual = 0;
      int lrc = ld.decompress(tl_decomp, cdata, csize, out, block.usize,
                              &actual);
      return lrc == 0 && actual == block.usize;
    }
  }
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(cdata);
  zs.avail_in = csize;
  zs.next_out = out;
  zs.avail_out = block.usize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == block.usize;
}

// Decompress a whole BGZF file with a thread pool.
static bool bgzf_decompress(const std::vector<uint8_t>& data,
                            std::vector<uint8_t>* out, int threads) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_bgzf_blocks(data, &blocks, &total)) return false;
  out->resize(total);
  if (blocks.empty()) return true;
  if (threads < 1) threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load()) break;
      if (!inflate_block(data, blocks[i], out->data() + blocks[i].uoffset))
        ok.store(false);
    }
    release_tl_decomp();  // pool threads exit here; see tl_decomp
  };
  std::vector<std::thread> pool;
  int nthreads = std::min<size_t>(threads, blocks.size());
  for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// ----------------------------------------------------------------- BAM spec

static const char SEQ_CODES[17] = "=ACMGRSVTWYHKDBN";
// cigar op properties, op order MIDNSHP=X
static const bool OP_CONSUMES_READ[9] = {true, true,  false, false, true,
                                         false, false, true,  true};
static const bool OP_CONSUMES_REF[9] = {true,  false, true, true, false,
                                        false, false, true, true};
enum { OP_M = 0, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X };

// event kinds (must match guacamole_tpu_torch.pack.events.EventKind)
enum { EV_BASE = 0, EV_INSERTION, EV_DELETION, EV_MID_DELETION, EV_CLIPPED };

struct Special {
  int64_t read_index;
  int64_t offset;   // offset within the read's reference span
  int32_t kind;     // EV_INSERTION or EV_DELETION
  int64_t payload_offset;
  int64_t payload_len;
  int32_t qual;
};

// A column that its decoder sizes once and then writes in full: resize()
// leaves the new elements uninitialised, where std::vector's would
// zero-fill every page on one thread first, for phase 2's threads to
// write again. push_back and insert still store their values.
template <class T>
struct DefaultInitAllocator : std::allocator<T> {
  template <class U>
  struct rebind {
    using other = DefaultInitAllocator<U>;
  };
  DefaultInitAllocator() = default;
  template <class U>
  DefaultInitAllocator(const DefaultInitAllocator<U>&) noexcept {}
  template <class U>
  void construct(U* p) noexcept {
    ::new (static_cast<void*>(p)) U;
  }
  template <class U, class... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};
template <class T>
using Column = std::vector<T, DefaultInitAllocator<T>>;

// Decoded, columnar output. Grows while parsing; exported as raw buffers.
struct Reads {
  // header
  std::string header_text;
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lengths;
  // per read scalars
  std::vector<int32_t> ref_id;
  std::vector<int64_t> start;
  std::vector<int64_t> end;  // start + padded reference length
  std::vector<int32_t> mapq;
  std::vector<uint16_t> flags;
  std::vector<int32_t> mate_ref_id;
  std::vector<int64_t> mate_start;
  std::vector<int32_t> tlen;
  std::vector<int32_t> mismatches;  // MD mismatch count (-1 = no MD)
  std::vector<int32_t> sample_id;
  // variable-length per read
  std::vector<int64_t> seq_off;    // n+1
  Column<uint8_t> seq;             // ASCII bases
  Column<uint8_t> qual;            // parallel to seq
  std::vector<int64_t> cigar_off;  // n+1
  Column<uint32_t> cigar_len;
  Column<uint8_t> cigar_op;
  std::vector<int64_t> md_off;     // n+1 offsets into md_text
  Column<uint8_t> md_text;         // raw MD strings
  // event arrays (length = reference span per read)
  std::vector<int64_t> ev_off;     // n+1
  Column<uint8_t> ev_kind;
  Column<uint8_t> ev_base;
  Column<uint8_t> ev_qual;
  Column<uint8_t> ev_mdref;        // MD-expanded reference bases (N if none)
  std::vector<Special> specials;
  std::vector<uint8_t> special_payload;
  std::vector<std::string> samples;  // sample names, indexed by sample_id
  std::string error;
};

// Parse @RG header lines: read-group id -> sample index.
static void parse_read_groups(const std::string& text,
                              std::map<std::string, int>* rg_to_sample,
                              std::vector<std::string>* samples) {
  size_t pos = 0;
  std::map<std::string, int> sample_ids;
  while (pos < text.size()) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = text.size();
    if (text.compare(pos, 4, "@RG\t") == 0) {
      std::string id, sm;
      size_t fpos = pos;
      while (fpos < eol) {
        size_t fend = text.find('\t', fpos);
        if (fend == std::string::npos || fend > eol) fend = eol;
        if (text.compare(fpos, 3, "ID:") == 0)
          id = text.substr(fpos + 3, fend - fpos - 3);
        else if (text.compare(fpos, 3, "SM:") == 0)
          sm = text.substr(fpos + 3, fend - fpos - 3);
        fpos = fend + 1;
      }
      if (!id.empty() && !sm.empty()) {
        auto it = sample_ids.find(sm);
        int sid;
        if (it == sample_ids.end()) {
          sid = samples->size();
          samples->push_back(sm);
          sample_ids[sm] = sid;
        } else {
          sid = it->second;
        }
        (*rg_to_sample)[id] = sid;
      }
    }
    pos = eol + 1;
  }
}

// [b, e) for a reason: printable ASCII, anything else as '?', at most 40
// characters (a reason is one line of text, tab-free).
static std::string shown(const char* b, const char* e) {
  std::string out;
  for (const char* p = b; p < e && out.size() < 40; p++)
    out.push_back(*p >= ' ' && *p <= '~' ? *p : '?');
  if (e - b > 40) out += "...";
  return out;
}

static bool ascii_letter(char ch) {
  return (ch >= 'A' && ch <= 'Z') || (ch >= 'a' && ch <= 'z');
}

// Expand MD tag + cigar + seq into reference bases and events for one read.
// Returns nullptr, or why the tag cannot be expanded: exactly the tags on
// which reads/mdtag.py's MdTag raises MdTagError (the caller refuses a
// read the object path places, and gives any other N reference).
static const char* expand_md(const char* md, size_t md_len,
                             const uint32_t* cigar, size_t n_cigar,
                             const uint8_t* seq, uint8_t* md_ref,
                             size_t span, int32_t* mismatch_count) {
  // MD text is runs of digits, single letters, and '^' before the
  // letters of a deletion; MdTag tokenizes the whole tag first.
  for (size_t i = 0; i < md_len; i++) {
    const char ch = md[i];
    if (ch == '^' ? !(i + 1 < md_len && ascii_letter(md[i + 1]))
                  : !(ascii_letter(ch) || (ch >= '0' && ch <= '9')))
      return "is not MD text";
  }
  size_t mi = 0;   // index into md string
  long run = 0;    // remaining matched bases
  bool have_run = false;
  int32_t mismatches = 0;
  size_t ref_pos = 0;  // offset into md_ref
  size_t read_pos = 0;

  auto next_token_run = [&]() -> bool {
    if (mi < md_len && md[mi] >= '0' && md[mi] <= '9') {
      run = 0;
      while (mi < md_len && md[mi] >= '0' && md[mi] <= '9')
        run = run * 10 + (md[mi++] - '0');
      have_run = true;
      return true;
    }
    return false;
  };
  next_token_run();

  for (size_t c = 0; c < n_cigar; c++) {
    uint32_t len = cigar[c] >> 4;
    uint32_t op = cigar[c] & 0xf;
    if (op > OP_X) return "meets a CIGAR op above 8";  // the tables hold 9
    if (op == OP_M || op == OP_EQ || op == OP_X) {
      uint32_t remaining = len;
      while (remaining > 0) {
        if (have_run && run > 0) {
          uint32_t step = (run < remaining) ? run : remaining;
          memcpy(md_ref + ref_pos, seq + read_pos, step);
          run -= step;
          remaining -= step;
          ref_pos += step;
          read_pos += step;
        } else {
          if (mi >= md_len) return "ended early for the CIGAR";
          char ch = md[mi];
          if (ch >= '0' && ch <= '9') {
            next_token_run();
          } else if (ch == '^') {
            return "has a deletion inside a match run";
          } else {
            md_ref[ref_pos++] = toupper(ch);
            mismatches++;
            read_pos++;
            remaining--;
            mi++;
            have_run = false;
            next_token_run();
          }
        }
      }
    } else if (op == OP_D) {
      // consume zero-length runs, then the ^-prefixed deletion
      while (have_run && run == 0 && mi < md_len && md[mi] == '^') break;
      if ((have_run && run > 0) || mi >= md_len || md[mi] != '^')
        return "lacks the deletion of a D op";
      mi++;
      for (uint32_t k = 0; k < len; k++) {
        if (mi >= md_len || !ascii_letter(md[mi]))
          return "has a deletion shorter than its D op";
        md_ref[ref_pos++] = toupper(md[mi++]);
      }
      if (mi < md_len && ascii_letter(md[mi]))
        return "has a deletion longer than its D op";
      have_run = false;
      next_token_run();
    } else if (op == OP_N) {
      memset(md_ref + ref_pos, 'N', len);
      ref_pos += len;
    } else if (op == OP_P) {
      memset(md_ref + ref_pos, 'N', len);
      ref_pos += len;
    } else if (OP_CONSUMES_READ[op]) {
      read_pos += len;
    }
  }
  *mismatch_count = mismatches;
  return nullptr;
}

// Build the per-locus event arrays for one read (mirrors
// pack/events.py read_pileup_events). Writes into caller-provided slices
// (pre-filled with EV_CLIPPED / 0 / mapq defaults); specials and their
// payload go to caller-provided buffers so read ranges can be processed
// in parallel and stitched in order.
static void build_events_at(int64_t read_index, int64_t start,
                            const uint32_t* cigar, size_t n_cigar,
                            const uint8_t* seq, const uint8_t* qual,
                            size_t seq_len, int32_t mapq,
                            uint8_t* kinds, uint8_t* bases, uint8_t* quals,
                            const uint8_t* md_ref, size_t span,
                            std::vector<Special>* specials,
                            std::vector<uint8_t>* payload) {
  size_t ref_offset = 0;
  size_t read_pos = 0;
  bool have_contig_start_insertion = false;
  size_t csi_payload_off = 0, csi_payload_len = 0;
  int csi_qual = 0;

  for (size_t c = 0; c < n_cigar; c++) {
    uint32_t len = cigar[c] >> 4;
    uint32_t op = cigar[c] & 0xf;
    uint32_t next_op = (c + 1 < n_cigar) ? (cigar[c + 1] & 0xf) : 0xff;
    uint32_t next_len = (c + 1 < n_cigar) ? (cigar[c + 1] >> 4) : 0;
    if (op == OP_M || op == OP_EQ || op == OP_X) {
      for (uint32_t k = 0; k < len; k++) {
        kinds[ref_offset + k] = EV_BASE;
        bases[ref_offset + k] = seq[read_pos + k];
        quals[ref_offset + k] = qual[read_pos + k];
      }
      size_t last = ref_offset + len - 1;
      size_t last_read = read_pos + len - 1;
      if (next_op == OP_I && op != OP_X) {
        // insertion anchored at this locus
        size_t m = next_len;
        size_t avail = seq_len - last_read;
        size_t take = (m + 1 < avail) ? m + 1 : avail;
        int minq = 255;
        for (size_t t = 0; t < take; t++)
          if (qual[last_read + t] < minq) minq = qual[last_read + t];
        kinds[last] = EV_INSERTION;
        quals[last] = (uint8_t)minq;
        bases[last] = 0;
        Special sp;
        sp.read_index = read_index;
        sp.offset = last;
        sp.kind = EV_INSERTION;
        sp.payload_offset = (int64_t)payload->size();
        sp.payload_len = take;
        sp.qual = minq;
        payload->insert(payload->end(), seq + last_read,
                        seq + last_read + take);
        specials->push_back(sp);
      } else if (next_op == OP_D) {
        // deletion anchored at this locus; tail from expanded md_ref
        kinds[last] = EV_DELETION;
        quals[last] = qual[last_read];
        bases[last] = 0;
        Special sp;
        sp.read_index = read_index;
        sp.offset = last;
        sp.kind = EV_DELETION;
        sp.payload_offset = (int64_t)payload->size();
        sp.payload_len = next_len;
        sp.qual = qual[last_read];
        // deleted bases live at md_ref[last+1 .. last+next_len]
        payload->insert(payload->end(), md_ref + last + 1,
                        md_ref + last + 1 + next_len);
        specials->push_back(sp);
      }
      read_pos += len;
      ref_offset += len;
    } else if (op == OP_D) {
      for (uint32_t k = 0; k < len; k++)
        kinds[ref_offset + k] = EV_MID_DELETION;
      ref_offset += len;
    } else if (op == OP_N || op == OP_P) {
      ref_offset += len;
    } else if (op == OP_I) {
      if (start + (int64_t)ref_offset == 0 && c + 1 < n_cigar && span > 0) {
        size_t avail = seq_len - read_pos;
        size_t take = (len + 1 < avail) ? len + 1 : avail;
        int minq = 255;
        for (size_t t = 0; t < take; t++)
          if (qual[read_pos + t] < minq) minq = qual[read_pos + t];
        have_contig_start_insertion = true;
        csi_payload_off = payload->size();
        csi_payload_len = take;
        csi_qual = minq;
        payload->insert(payload->end(), seq + read_pos,
                        seq + read_pos + take);
      }
      read_pos += len;
    } else if (op == OP_S) {
      read_pos += len;
    }
  }

  if (have_contig_start_insertion) {
    kinds[0] = EV_INSERTION;
    bases[0] = 0;
    quals[0] = (uint8_t)csi_qual;
    Special sp;
    sp.read_index = read_index;
    sp.offset = 0;
    sp.kind = EV_INSERTION;
    sp.payload_offset = (int64_t)csi_payload_off;
    sp.payload_len = (int64_t)csi_payload_len;
    sp.qual = csi_qual;
    specials->push_back(sp);
  }
}

// Parse the BAM header + reference list from the uncompressed prefix.
// avail = number of valid leading bytes of u. Returns: 0 ok (header_end
// set past the refs), 1 need more data, 2 malformed.
static int parse_bam_header(const std::vector<uint8_t>& u, size_t avail,
                            Reads* r, std::map<std::string, int>* rg_to_sample,
                            size_t* header_end) {
  if (avail < 12) return 1;
  if (memcmp(u.data(), "BAM\x01", 4) != 0) {
    r->error = "not a BAM file";
    return 2;
  }
  int32_t l_text;
  memcpy(&l_text, &u[4], 4);
  if (l_text < 0) {
    r->error = "malformed BAM header (negative l_text)";
    return 2;
  }
  size_t pos = 8;
  if (pos + (size_t)l_text + 4 > avail) return 1;
  r->header_text.assign(reinterpret_cast<const char*>(&u[pos]), l_text);
  pos += l_text;
  int32_t n_ref;
  memcpy(&n_ref, &u[pos], 4);
  pos += 4;
  if (n_ref < 0) {
    r->error = "malformed BAM header (negative n_ref)";
    return 2;
  }
  r->ref_names.clear();
  r->ref_lengths.clear();
  for (int i = 0; i < n_ref; i++) {
    if (pos + 4 > avail) return 1;
    int32_t l_name;
    memcpy(&l_name, &u[pos], 4);
    pos += 4;
    if (l_name <= 0) {
      r->error = "malformed BAM header (bad reference name length)";
      return 2;
    }
    if (pos + (size_t)l_name + 4 > avail) return 1;
    r->ref_names.emplace_back(reinterpret_cast<const char*>(&u[pos]),
                              l_name - 1);
    pos += l_name;
    int32_t l_ref;
    memcpy(&l_ref, &u[pos], 4);
    pos += 4;
    r->ref_lengths.push_back(l_ref);
  }
  parse_read_groups(r->header_text, rg_to_sample, &r->samples);
  *header_end = pos;
  return 0;
}

// The records of one run of inflated bytes (a .bai chunk's, or the whole
// file's): those that start in [begin, end). Each must end by limit, where
// the run's bytes end (BAI chunk ends are record-aligned; the caller
// inflates the overhang). A reason gives a record's offset from base,
// where the run's bytes begin.
struct RecordRange {
  size_t base, begin, end, limit;
};

// What the serial scan keeps of a record for phase 2.
struct RecMeta {
  const uint8_t* rec;
  const char* md;
  int32_t md_len;
  int32_t l_seq;
  uint16_t n_cigar;
  uint8_t l_read_name;
  uint8_t consistent;
  int64_t span;
  int64_t pos0;
  uint8_t mapq;
  uint8_t placed;  // mapped with a reference and a position, as gio/bam.py
  size_t at;       // offset of the record in the inflated bytes
};

// Refuses the record at `at` of range: r->error names the field and the
// record's offset in its range.
static bool reject_record(Reads* r, const RecordRange& range, size_t at,
                          const std::string& why) {
  r->error = "malformed BAM record at inflated byte " +
             std::to_string(at - range.base) + ": " + why;
  return false;
}

// Phase 1 of parse_bam_records over one range: a cheap serial scan finds
// record boundaries, scalar fields, tag locations, and per-read array
// offsets. Every field is bounded by its record's block before it is
// used. A record that fails a check ends the scan, and phase 2 never sees
// a record that was not checked.
static bool scan_bam_records(const uint8_t* u, const RecordRange& range,
                             Reads* r,
                             const std::map<std::string, int>& rg_to_sample,
                             int& default_sample,
                             std::vector<RecMeta>& metas) {
  auto reject = [&](size_t at, const std::string& why) {
    return reject_record(r, range, at, why);
  };
  size_t pos = range.begin;
  while (pos < range.end) {
    const size_t at = pos;
    if (pos + 4 > range.limit)
      return reject(at, "block_size cut by the end of the data");
    int32_t block_size;
    memcpy(&block_size, &u[pos], 4);
    if (block_size < 32)
      return reject(at, "block_size " + std::to_string(block_size) +
                            " below the 32 bytes of fixed fields");
    if (pos + 4 + (size_t)block_size > range.limit)
      return reject(at, "block_size " + std::to_string(block_size) +
                            " past the end of the data");
    const uint8_t* rec = &u[pos + 4];
    pos += 4 + block_size;

    int32_t ref_id, pos0, l_read_name_etc, flag_nc, l_seq, next_ref, next_pos,
        tlen;
    memcpy(&ref_id, rec + 0, 4);
    memcpy(&pos0, rec + 4, 4);
    memcpy(&l_read_name_etc, rec + 8, 4);
    memcpy(&flag_nc, rec + 12, 4);
    memcpy(&l_seq, rec + 16, 4);
    memcpy(&next_ref, rec + 20, 4);
    memcpy(&next_pos, rec + 24, 4);
    memcpy(&tlen, rec + 28, 4);
    // A reference id indexes the header's list, -1 for none; a position
    // is 0-based, -1 for none.
    const int32_t n_ref = (int32_t)r->ref_names.size();
    if (ref_id < -1 || ref_id >= n_ref)
      return reject(at, "ref_id " + std::to_string(ref_id) +
                            " outside the header's " + std::to_string(n_ref) +
                            " references");
    if (next_ref < -1 || next_ref >= n_ref)
      return reject(at, "next_ref " + std::to_string(next_ref) +
                            " outside the header's " + std::to_string(n_ref) +
                            " references");
    if (pos0 < -1)
      return reject(at, "pos " + std::to_string(pos0) + " below -1");
    if (next_pos < -1)
      return reject(at, "next_pos " + std::to_string(next_pos) + " below -1");
    uint8_t l_read_name = l_read_name_etc & 0xff;
    uint8_t mapq = (l_read_name_etc >> 8) & 0xff;
    uint16_t n_cigar = flag_nc & 0xffff;
    uint16_t flag = (flag_nc >> 16) & 0xffff;
    if (l_seq < 0)
      return reject(at, "negative l_seq " + std::to_string(l_seq));
    // At most 32 + 255 + 4 * 65535 + 1.5 * (2^31 - 1): no overflow.
    const size_t need = 32 + (size_t)l_read_name + 4 * (size_t)n_cigar +
                        ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
    if (need > (size_t)block_size)
      return reject(at, "l_read_name " + std::to_string(l_read_name) +
                            ", n_cigar " + std::to_string(n_cigar) +
                            " and l_seq " + std::to_string(l_seq) + " need " +
                            std::to_string(need) + " bytes, block_size is " +
                            std::to_string(block_size));

    size_t p = 32 + l_read_name;
    const uint32_t* cigar = reinterpret_cast<const uint32_t*>(rec + p);
    p += 4 * n_cigar;
    p += (l_seq + 1) / 2;  // seq nibbles (decoded in phase 2)
    p += l_seq;            // quals (copied in phase 2)

    // tag scan: MD (Z) and RG (Z)
    const char* md = nullptr;
    size_t md_len = 0;
    int sample = -1;
    {
      size_t tp = p;
      size_t rec_len = block_size;
      while (tp + 3 <= rec_len) {
        char t0 = rec[tp], t1 = rec[tp + 1];
        char typ = rec[tp + 2];
        tp += 3;
        size_t size = 0;
        switch (typ) {
          case 'A': case 'c': case 'C': size = 1; break;
          case 's': case 'S': size = 2; break;
          case 'i': case 'I': case 'f': size = 4; break;
          case 'Z': case 'H': {
            size_t z = tp;
            while (z < rec_len && rec[z] != 0) z++;
            if (t0 == 'M' && t1 == 'D' && typ == 'Z') {
              md = reinterpret_cast<const char*>(rec + tp);
              md_len = z - tp;
            } else if (t0 == 'R' && t1 == 'G' && typ == 'Z') {
              std::string rg(reinterpret_cast<const char*>(rec + tp), z - tp);
              auto it = rg_to_sample.find(rg);
              if (it != rg_to_sample.end()) sample = it->second;
            }
            tp = z + 1;
            continue;
          }
          case 'B': {
            if (tp + 5 > rec_len)
              return reject(at, "B tag header cut by block_size");
            uint8_t sub = rec[tp];
            uint32_t count;
            memcpy(&count, rec + tp + 1, 4);
            size_t esize = (sub == 'c' || sub == 'C') ? 1
                           : (sub == 's' || sub == 'S') ? 2 : 4;
            // A uint32 count times at most 4 fits a 64-bit size_t.
            if ((uint64_t)count * esize > rec_len - (tp + 5))
              return reject(at, "B tag count " + std::to_string(count) +
                                    " past block_size");
            tp += 5 + count * esize;
            continue;
          }
          default:
            tp = rec_len;  // unknown tag type: stop scanning
            continue;
        }
        tp += size;
      }
    }
    if (sample < 0) {
      if (default_sample < 0) {
        default_sample = r->samples.size();
        r->samples.push_back("default");
      }
      sample = default_sample;
    }

    // reference span (padded: M/D/N/=/X/P) + read-length consistency
    int64_t span = 0;
    int64_t read_len_from_cigar = 0;
    for (int i = 0; i < n_cigar; i++) {
      uint32_t op = cigar[i] & 0xf;
      uint32_t len = cigar[i] >> 4;
      if (op > OP_X)
        return reject(at, "CIGAR op code " + std::to_string(op) + " above 8");
      if (OP_CONSUMES_REF[op] || op == OP_P) span += len;
      if (OP_CONSUMES_READ[op]) read_len_from_cigar += len;
    }
    // Positions are int32 in the BAM spec; a larger end would size the
    // event arrays past any memory. The span sizes them for an unmapped
    // record (pos -1) too.
    if ((int64_t)std::max(pos0, 0) + span > INT32_MAX)
      return reject(at, "pos " + std::to_string(pos0) + " + CIGAR span " +
                            std::to_string(span) + " past 2^31 - 1");

    r->ref_id.push_back(ref_id);
    r->start.push_back(pos0);
    r->end.push_back(pos0 + span);
    r->mapq.push_back(mapq);
    r->flags.push_back(flag);
    r->mate_ref_id.push_back(next_ref);
    r->mate_start.push_back(next_pos);
    r->tlen.push_back(tlen);
    r->sample_id.push_back(sample);
    r->mismatches.push_back(0);  // phase 2 fills the real count
    r->seq_off.push_back(r->seq_off.back() + l_seq);
    r->cigar_off.push_back(r->cigar_off.back() + n_cigar);
    r->md_off.push_back(r->md_off.back() + (int64_t)md_len);
    r->ev_off.push_back(r->ev_off.back() + span);

    RecMeta m;
    m.rec = rec;
    m.md = md;
    m.md_len = (int32_t)md_len;
    m.l_seq = l_seq;
    m.n_cigar = n_cigar;
    m.l_read_name = l_read_name;
    m.consistent = read_len_from_cigar == l_seq ? 1 : 0;
    m.span = span;
    m.pos0 = pos0;
    m.mapq = mapq;
    m.placed = !(flag & 4) && ref_id >= 0 && pos0 >= 0;
    m.at = at;
    metas.push_back(m);
  }
  return true;
}

// Parse the alignment records of ranges, in order, into r, which holds a
// header and no read yet. Two-phase record parse: the serial scan
// (scan_bam_records) over every range, then the heavy per-byte work (seq
// nibble decode, MD expansion, event construction) fills the columns, each
// sized once, in parallel over contiguous read ranges. On a refusal,
// r->error says why and *bad_range is the range of the record at fault:
// the first refused in the scan, unless phase 2 refuses an MD tag in a
// range before it, as a parse range by range would.
static bool parse_bam_records(const uint8_t* u,
                              const std::vector<RecordRange>& ranges,
                              Reads* r,
                              const std::map<std::string, int>& rg_to_sample,
                              int threads, size_t* bad_range) {
  int default_sample = -1;  // created lazily
  std::vector<RecMeta> metas;
  metas.reserve(1024);

  // ---- Phase 1: serial boundary scan + scalar columns + offsets ----
  size_t scanned = 0;  // ranges scanned whole
  for (; scanned < ranges.size(); scanned++) {
    const size_t kept = metas.size();
    if (!scan_bam_records(u, ranges[scanned], r, rg_to_sample,
                          default_sample, metas)) {
      metas.resize(kept);  // phase 2 runs over the ranges before it
      break;
    }
  }
  *bad_range = scanned;

  size_t n_new = metas.size();
  if (n_new == 0) return scanned == ranges.size();

  r->seq.resize((size_t)r->seq_off[n_new]);
  r->qual.resize((size_t)r->seq_off[n_new]);
  r->cigar_len.resize((size_t)r->cigar_off[n_new]);
  r->cigar_op.resize((size_t)r->cigar_off[n_new]);
  r->md_text.resize((size_t)r->md_off[n_new]);
  r->ev_kind.resize((size_t)r->ev_off[n_new]);
  r->ev_base.resize((size_t)r->ev_off[n_new]);
  r->ev_qual.resize((size_t)r->ev_off[n_new]);
  r->ev_mdref.resize((size_t)r->ev_off[n_new]);

  // ---- Phase 2: parallel per-read fills over contiguous ranges ----
  if (threads < 1) threads = 1;
  int nthreads = (int)std::min<size_t>((size_t)threads, n_new);
  size_t per = (n_new + nthreads - 1) / nthreads;
  std::vector<std::vector<Special>> range_specials(nthreads);
  std::vector<std::vector<uint8_t>> range_payload(nthreads);
  // Per range, its first placed record whose MD tag cannot be expanded.
  std::vector<std::pair<size_t, const char*>> md_faults(nthreads,
                                                        {SIZE_MAX, nullptr});

  auto work = [&](int t) {
    size_t lo = (size_t)t * per;
    size_t hi = std::min(lo + per, n_new);
    auto& specials = range_specials[t];
    auto& payload = range_payload[t];
    for (size_t k = lo; k < hi; k++) {
      const RecMeta& m = metas[k];
      int64_t ri = (int64_t)k;
      const uint8_t* rec = m.rec;
      size_t p = 32 + m.l_read_name;
      const uint32_t* cigar = reinterpret_cast<const uint32_t*>(rec + p);
      p += 4 * m.n_cigar;

      // seq nibble decode (two bases per input byte)
      int64_t seq_start = r->seq_off[ri];
      uint8_t* seq_out = r->seq.data() + seq_start;
      const uint8_t* packed = rec + p;
      int32_t pairs = m.l_seq / 2;
      for (int32_t i = 0; i < pairs; i++) {
        uint8_t b = packed[i];
        seq_out[2 * i] = SEQ_CODES[b >> 4];
        seq_out[2 * i + 1] = SEQ_CODES[b & 0xf];
      }
      if (m.l_seq & 1) seq_out[m.l_seq - 1] = SEQ_CODES[packed[pairs] >> 4];
      p += (m.l_seq + 1) / 2;

      // quals
      uint8_t* qual_out = r->qual.data() + seq_start;
      if (m.l_seq > 0 && rec[p] == 0xff) {
        memset(qual_out, 0, m.l_seq);
      } else if (m.l_seq > 0) {
        memcpy(qual_out, rec + p, m.l_seq);
      }

      // cigar columns
      int64_t coff = r->cigar_off[ri];
      for (int i = 0; i < m.n_cigar; i++) {
        r->cigar_len[coff + i] = cigar[i] >> 4;
        r->cigar_op[coff + i] = cigar[i] & 0xf;
      }

      // raw MD text
      if (m.md_len > 0)
        memcpy(r->md_text.data() + r->md_off[ri], m.md, m.md_len);

      // md_ref expansion + events
      int64_t ev_start = r->ev_off[ri];
      size_t span = (size_t)m.span;
      uint8_t* mdref = r->ev_mdref.data() + ev_start;
      memset(mdref, 'N', span);
      int32_t mm = -1;
      if (m.md != nullptr && m.consistent) {
        const char* fault = expand_md(m.md, (size_t)m.md_len, cigar,
                                      m.n_cigar, seq_out, mdref, span, &mm);
        if (fault != nullptr) {
          memset(mdref, 'N', span);
          mm = -1;
          if (m.placed && md_faults[t].first == SIZE_MAX)
            md_faults[t] = {k, fault};
        }
      }
      r->mismatches[ri] = mm < 0 ? 0 : mm;

      uint8_t* kinds = r->ev_kind.data() + ev_start;
      uint8_t* bases = r->ev_base.data() + ev_start;
      uint8_t* equals = r->ev_qual.data() + ev_start;
      memset(kinds, EV_CLIPPED, span);
      memset(bases, 0, span);
      memset(equals, (uint8_t)m.mapq, span);
      if (m.consistent && span > 0) {
        build_events_at(ri, m.pos0, cigar, m.n_cigar, seq_out, qual_out,
                        (size_t)m.l_seq, m.mapq, kinds, bases, equals,
                        mdref, span, &specials, &payload);
      }
    }
  };
  if (nthreads <= 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  // A tag the object path raises on refuses the decode, at its first
  // record (ranges are in read order).
  for (const auto& fault : md_faults) {
    if (fault.first == SIZE_MAX) continue;
    const RecMeta& m = metas[fault.first];
    size_t k = 0;
    while (m.at >= ranges[k].limit) k++;  // ranges lie in order in u
    *bad_range = k;
    return reject_record(r, ranges[k], m.at,
                         "MD tag \"" + shown(m.md, m.md + m.md_len) +
                             "\" " + fault.second);
  }
  if (scanned < ranges.size()) return false;  // the scan's refusal

  // Stitch per-range specials (ranges are in read order).
  for (int t = 0; t < nthreads; t++) {
    int64_t base = (int64_t)r->special_payload.size();
    for (Special sp : range_specials[t]) {
      sp.payload_offset += base;
      r->specials.push_back(sp);
    }
    r->special_payload.insert(r->special_payload.end(),
                              range_payload[t].begin(),
                              range_payload[t].end());
  }
  return true;
}

static bool parse_bam(const std::vector<uint8_t>& u, Reads* r,
                      int threads) {
  std::map<std::string, int> rg_to_sample;
  size_t header_end = 0;
  int rc = parse_bam_header(u, u.size(), r, &rg_to_sample, &header_end);
  if (rc != 0) {
    if (r->error.empty()) r->error = "truncated BAM header";
    return false;
  }
  r->seq_off.push_back(0);
  r->cigar_off.push_back(0);
  r->md_off.push_back(0);
  r->ev_off.push_back(0);
  size_t bad_range;
  return parse_bam_records(u.data(), {{0, header_end, u.size(), u.size()}},
                           r, rg_to_sample, threads, &bad_range);
}

// Incremental BGZF reader over a file handle: reads and inflates blocks
// on demand, so only the byte ranges actually requested are touched.
struct BgzfStream {
  FILE* f = nullptr;
  size_t fsize = 0;

  bool open(const char* path) {
    f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    fsize = (size_t)ftell(f);
    return true;
  }
  ~BgzfStream() {
    if (f) fclose(f);
  }

  // Read + inflate the block at coffset. Appends the uncompressed bytes to
  // out and sets *bsize to the compressed block size. Returns false on
  // EOF/corruption.
  bool inflate_at(size_t coffset, std::vector<uint8_t>* out, size_t* bsize) {
    if (coffset + 28 > fsize) return false;
    uint8_t hdr[12];
    fseek(f, (long)coffset, SEEK_SET);
    if (fread(hdr, 1, 12, f) != 12) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b || !(hdr[3] & 0x04)) return false;
    uint16_t xlen;
    memcpy(&xlen, hdr + 10, 2);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f) != xlen) return false;
    size_t bs = 0;
    for (size_t pos = 0; pos + 4 <= xlen;) {
      uint8_t si1 = extra[pos], si2 = extra[pos + 1];
      uint16_t slen;
      memcpy(&slen, &extra[pos + 2], 2);
      if (pos + 4 + slen > xlen) return false;
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t b;
        memcpy(&b, &extra[pos + 4], 2);
        bs = (size_t)b + 1;
      }
      pos += 4 + slen;
    }
    if (bs < 12 + (size_t)xlen + 8 || coffset + bs > fsize) return false;
    size_t csize = bs - 12 - xlen - 8;
    std::vector<uint8_t> cdata(csize + 8);
    if (fread(cdata.data(), 1, csize + 8, f) != csize + 8) return false;
    uint32_t isize;
    memcpy(&isize, cdata.data() + csize + 4, 4);
    if (isize > kBgzfMaxBlock) return false;
    size_t base = out->size();
    out->resize(base + isize);
    if (isize > 0) {
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) return false;
      zs.next_in = cdata.data();
      zs.avail_in = csize;
      zs.next_out = out->data() + base;
      zs.avail_out = isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END || zs.total_out != isize) return false;
    }
    *bsize = bs;
    return true;
  }
};

// Reads the compressed range of chunk [vbeg, vend) onto the end of cbuf in
// ONE read — [c0, c1] plus two max-size blocks of slack (the block
// containing the end voffset and one more for a record overhanging vend) —
// and walks its block headers onto blocks: offsets in cbuf, and in the
// pass's inflated bytes from ubase on. Sets *range to the records the
// chunk covers there. Returns why the chunk cannot be walked, or "".
static std::string walk_chunk(BgzfStream& stream, int64_t vbeg, int64_t vend,
                              size_t header_end, std::vector<uint8_t>* cbuf,
                              std::vector<BgzfBlock>* blocks, size_t ubase,
                              RecordRange* range) {
  uint64_t c0 = (uint64_t)vbeg >> 16;
  uint64_t c1 = (uint64_t)vend >> 16;
  size_t u0 = (uint64_t)vbeg & 0xffff;
  size_t u1 = (uint64_t)vend & 0xffff;
  size_t uend = SIZE_MAX;  // chunk-local uoffset of the chunk end
  if ((size_t)c0 >= stream.fsize)
    return "starts at compressed offset " + std::to_string(c0) +
           ", at or past the end of the file (" +
           std::to_string(stream.fsize) + " bytes)";
  size_t guess_end = std::min(stream.fsize, (size_t)c1 + 2 * 65536 + 28);
  if (guess_end <= (size_t)c0)
    guess_end = std::min(stream.fsize, (size_t)c0 + 2 * 65536 + 28);
  const size_t cbase = cbuf->size(), clen = guess_end - (size_t)c0;
  cbuf->resize(cbase + clen);
  uint8_t* cb = cbuf->data() + cbase;
  if (fseek(stream.f, (long)c0, SEEK_SET) != 0)
    return "cannot seek to compressed offset " + std::to_string(c0);
  if (fread(cb, 1, clen, stream.f) != clen)
    return "cannot read " + std::to_string(clen) +
           " bytes at compressed offset " + std::to_string(c0);
  const size_t first = blocks->size();
  size_t loff = 0, uoff = 0, end_isize = 0;
  bool have_end = false, slack_done = false;
  while (!(have_end && slack_done) && loff + 28 <= clen) {
    if (cb[loff] != 0x1f || cb[loff + 1] != 0x8b || !(cb[loff + 3] & 0x04))
      break;
    uint16_t xlen;
    memcpy(&xlen, &cb[loff + 10], 2);
    if (loff + 12 + xlen > clen) break;
    size_t pos = loff + 12, hend = pos + xlen, bsize = 0;
    while (pos + 4 <= hend) {
      uint8_t si1 = cb[pos], si2 = cb[pos + 1];
      uint16_t slen;
      memcpy(&slen, &cb[pos + 2], 2);
      if (pos + 4 + slen > hend) {
        bsize = 0;  // a subfield overruns the header: malformed
        break;
      }
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, &cb[pos + 4], 2);
        bsize = (size_t)bs + 1;
      }
      pos += 4 + slen;
    }
    if (bsize < 12 + (size_t)xlen + 8 || loff + bsize > clen) break;
    uint32_t isize;
    memcpy(&isize, &cb[loff + bsize - 4], 4);
    if (isize > kBgzfMaxBlock) break;
    size_t abs_off = (size_t)c0 + loff;
    if (!have_end) {
      if (abs_off == (size_t)c1) {
        have_end = true;
        uend = uoff + u1;
        end_isize = isize;
      } else if (abs_off > (size_t)c1) {
        return "ends at compressed offset " + std::to_string(c1) +
               ", where no block starts";
      }
    } else {
      slack_done = true;  // the one slack block — include it
    }
    blocks->push_back({cbase + loff, bsize, ubase + uoff, isize});
    uoff += isize;
    loff += bsize;
  }
  // The walk must reach the block at c1, or the end of the file (the EOF
  // convention below); it stops before either only at a block header it
  // cannot read: a cut or corrupt file, or a .bai of another file.
  if (!have_end && (size_t)c0 + loff != stream.fsize)
    return "no readable block header at compressed offset " +
           std::to_string((size_t)c0 + loff) +
           ", before the chunk's end block at " + std::to_string(c1);
  // A walk that read the whole file ends the chunk there only where the
  // index says so (an index writes file size << 16 for the last end): an
  // end further on is a chunk of a longer file, whose lost blocks' reads
  // would go missing. Only the 28 bytes of an EOF marker, which hold no
  // read, may be missing (the same file with its marker).
  if ((size_t)c1 > stream.fsize + sizeof(kBgzfEof))
    return "ends at compressed offset " + std::to_string(c1) +
           ", past the end of the file (" + std::to_string(stream.fsize) +
           " bytes) by more than an EOF marker";
  if (u0 > (*blocks)[first].usize)
    return "starts at byte " + std::to_string(u0) +
           " of a block that inflates to " +
           std::to_string((*blocks)[first].usize);
  if (have_end && u1 > end_isize)
    return "ends at byte " + std::to_string(u1) +
           " of a block that inflates to " + std::to_string(end_isize);
  // End voffset past the last data block (EOF convention): the walk
  // reached the end of the file, and the chunk covers everything walked.
  uend = std::min(uend, uoff);
  size_t ustart = std::min(u0, uoff);
  if (c0 == 0) ustart = std::max(ustart, header_end);
  *range = {ubase, ubase + ustart, ubase + uend, ubase + uoff};
  return "";
}

// Decode only the records covered by BGZF virtual-offset chunks (from a
// .bai query; the TPU-native analog of the reference's BAM-index pushdown,
// Read.scala:395-406). Only the chunks' byte ranges are read and inflated,
// all chunks in one pass: every chunk walked, one inflate pool over all
// their blocks, one record parse over all their ranges, with its columns
// sized once. Memory is O(header + the chunks' inflated bytes), not
// O(file).
static Reads* decode_bam_chunks(const char* path, int threads,
                                int64_t n_chunks, const int64_t* vbeg,
                                const int64_t* vend) {
  BgzfStream stream;
  if (!stream.open(path)) return decode_failed("cannot open the file");

  // Header: inflate leading blocks until the header + refs parse.
  std::unique_ptr<Reads> r(new Reads());
  std::map<std::string, int> rg_to_sample;
  std::vector<uint8_t> hdr_u;
  size_t header_end = 0;
  size_t hdr_coffset = 0;
  int rc = 1;
  while (rc == 1) {
    size_t bsize = 0;
    if (!stream.inflate_at(hdr_coffset, &hdr_u, &bsize)) break;
    hdr_coffset += bsize;
    rc = parse_bam_header(hdr_u, hdr_u.size(), r.get(), &rg_to_sample,
                          &header_end);
  }
  if (rc != 0)
    return decode_failed(r->error.empty() ? "truncated BAM header" : r->error);

  r->seq_off.push_back(0);
  r->cigar_off.push_back(0);
  r->md_off.push_back(0);
  r->ev_off.push_back(0);

  // The first chunk at fault, and why. Each step below runs over the
  // chunks before it and refuses an earlier one in its place, so the
  // refusal is the one of a decode chunk by chunk: a decode that kept the
  // records before the fault would lose reads in silence.
  int64_t bad = n_chunks;
  std::string why;
  auto refuse = [&](int64_t c, const std::string& reason) {
    bad = c;
    why = "chunk " + std::to_string(c) + " [" + std::to_string(vbeg[c]) +
          ", " + std::to_string(vend[c]) + "): " + reason;
  };

  // Walk the chunks in order, to the first that cannot be walked.
  std::vector<uint8_t> cbuf;        // the chunks' compressed byte ranges
  std::vector<BgzfBlock> blocks;    // coffset in cbuf, uoffset in u
  std::vector<int64_t> block_chunk;
  std::vector<RecordRange> ranges;  // one a chunk
  size_t utotal = 0;
  for (int64_t c = 0; c < n_chunks; c++) {
    const size_t first = blocks.size();
    RecordRange range;
    const std::string fault = walk_chunk(stream, vbeg[c], vend[c], header_end,
                                         &cbuf, &blocks, utotal, &range);
    if (!fault.empty()) {
      blocks.resize(first);
      refuse(c, fault);
      break;
    }
    block_chunk.resize(blocks.size(), c);
    ranges.push_back(range);
    utotal = range.limit;
  }

  // Inflate every walked block with one thread pool; the first block that
  // does not inflate refuses its chunk. The pool writes every byte of u.
  Column<uint8_t> u;
  u.resize(utotal);
  if (!blocks.empty()) {
    std::atomic<size_t> next_b(0), bad_block(SIZE_MAX);
    auto worker = [&]() {
      while (true) {
        size_t i = next_b.fetch_add(1);
        if (i >= blocks.size() || i > bad_block.load()) break;
        if (!inflate_block(cbuf, blocks[i], u.data() + blocks[i].uoffset)) {
          size_t seen = bad_block.load();
          while (i < seen && !bad_block.compare_exchange_weak(seen, i)) {
          }
        }
      }
      release_tl_decomp();  // pool threads exit here; see tl_decomp
    };
    int nthreads =
        (int)std::min<size_t>(threads < 1 ? 1 : threads, blocks.size());
    if (nthreads <= 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
      for (auto& th : pool) th.join();
    }
    if (bad_block.load() != SIZE_MAX)
      refuse(block_chunk[bad_block.load()], "malformed BGZF block");
  }

  // Parse the records of the chunks before the first at fault in one pass.
  ranges.resize(std::min<size_t>(ranges.size(), (size_t)bad));
  size_t bad_range = 0;
  if (!parse_bam_records(u.data(), ranges, r.get(), rg_to_sample, threads,
                         &bad_range))
    refuse((int64_t)bad_range, r->error);
  if (bad < n_chunks) return decode_failed(why);
  return r.release();
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

// Why the last guac_decode_bam, guac_decode_bam_chunks or guac_decode_sam
// on the calling thread returned no handle (empty after a success).
const char* guac_last_error() { return g_last_error.c_str(); }

// Opaque handle
void* guac_decode_bam(const char* path, int threads) {
  return guarded([&]() -> void* {
    std::vector<uint8_t> raw;
    if (!read_file(path, &raw)) return decode_failed("cannot read the file");
    std::vector<uint8_t> uncompressed;
    if (!bgzf_decompress(raw, &uncompressed, threads))
      return decode_failed("malformed BGZF block");
    std::unique_ptr<Reads> r(new Reads());
    if (!parse_bam(uncompressed, r.get(), threads))
      return decode_failed(r->error);
    // A BAM that lost whole trailing blocks reads like one written without
    // the marker: as htslib does, say so, and decode all the same.
    if (raw.size() < sizeof(kBgzfEof) ||
        memcmp(raw.data() + raw.size() - sizeof(kBgzfEof), kBgzfEof,
               sizeof(kBgzfEof)) != 0)
      fprintf(stderr,
              "warning: %s: no BGZF EOF marker, the file may be truncated\n",
              path);
    return r.release();
  });
}

// Region-pushdown decode: only records in the given BGZF virtual-offset
// chunks (merged, disjoint, from a .bai query) are decoded; only the
// blocks those chunks touch are inflated.
void* guac_decode_bam_chunks(const char* path, int threads, int64_t n_chunks,
                             const int64_t* vbeg, const int64_t* vend) {
  return guarded([&]() -> void* {
    return decode_bam_chunks(path, threads, n_chunks, vbeg, vend);
  });
}

void guac_free_reads(void* handle) { delete static_cast<Reads*>(handle); }

int64_t guac_num_reads(void* h) {
  return static_cast<Reads*>(h)->start.size();
}
int64_t guac_num_refs(void* h) {
  return static_cast<Reads*>(h)->ref_names.size();
}
const char* guac_ref_name(void* h, int64_t i) {
  return static_cast<Reads*>(h)->ref_names[i].c_str();
}
int64_t guac_ref_length(void* h, int64_t i) {
  return static_cast<Reads*>(h)->ref_lengths[i];
}
int64_t guac_num_samples(void* h) {
  return static_cast<Reads*>(h)->samples.size();
}
const char* guac_sample_name(void* h, int64_t i) {
  return static_cast<Reads*>(h)->samples[i].c_str();
}
const char* guac_header_text(void* h) {
  return static_cast<Reads*>(h)->header_text.c_str();
}

// Buffer accessors: return pointer + element count via out-param.
#define ACCESSOR(name, field, ctype)                         \
  const ctype* guac_##name(void* h, int64_t* n) {            \
    Reads* r = static_cast<Reads*>(h);                       \
    *n = (int64_t)r->field.size();                           \
    return r->field.data();                                  \
  }

ACCESSOR(ref_id, ref_id, int32_t)
ACCESSOR(start, start, int64_t)
ACCESSOR(end, end, int64_t)
ACCESSOR(mapq, mapq, int32_t)
ACCESSOR(flags, flags, uint16_t)
ACCESSOR(mate_ref_id, mate_ref_id, int32_t)
ACCESSOR(mate_start, mate_start, int64_t)
ACCESSOR(tlen, tlen, int32_t)
ACCESSOR(mismatches, mismatches, int32_t)
ACCESSOR(sample_id, sample_id, int32_t)
ACCESSOR(seq_off, seq_off, int64_t)
ACCESSOR(seq, seq, uint8_t)
ACCESSOR(qual, qual, uint8_t)
ACCESSOR(cigar_off, cigar_off, int64_t)
ACCESSOR(cigar_len, cigar_len, uint32_t)
ACCESSOR(cigar_op, cigar_op, uint8_t)
ACCESSOR(md_off, md_off, int64_t)
ACCESSOR(md_text, md_text, uint8_t)
ACCESSOR(ev_off, ev_off, int64_t)
ACCESSOR(ev_kind, ev_kind, uint8_t)
ACCESSOR(ev_base, ev_base, uint8_t)
ACCESSOR(ev_qual, ev_qual, uint8_t)
ACCESSOR(ev_mdref, ev_mdref, uint8_t)
ACCESSOR(special_payload, special_payload, uint8_t)

}  // extern "C"

namespace {

// Fill the per-locus event arrays for reads supplied as columnar buffers,
// with the SAME code the BAM decoder's phase 2 uses (mirrors
// pack/events.py read_pileup_events). Outputs are caller-allocated
// (ev_* sized ev_off[n], mismatches [n]); specials + payload append to r.
// Returns the first read with placed[i] set whose MD tag cannot be
// expanded, and sets *md_why to why; -1 where there is none (or no
// placed).
int64_t fill_events_columns(
    int64_t n, const int64_t* start, const int32_t* mapq,
    const int64_t* seq_off, const uint8_t* seq, const uint8_t* qual,
    const int64_t* cigar_off, const uint32_t* cigar_len,
    const uint8_t* cigar_op, const int64_t* md_off, const uint8_t* md_text,
    const int64_t* ev_off, int threads, uint8_t* ev_kind, uint8_t* ev_base,
    uint8_t* ev_qual, uint8_t* ev_mdref, int32_t* mismatches, Reads* r,
    const uint8_t* placed = nullptr, const char** md_why = nullptr) {
  if (n <= 0) return -1;
  if (threads < 1) {
    threads = (int)std::min<unsigned>(std::thread::hardware_concurrency(), 16);
    if (threads < 1) threads = 1;
  }
  int nthreads = (int)std::min<int64_t>(threads, n);
  int64_t per = (n + nthreads - 1) / nthreads;
  std::vector<std::vector<Special>> range_specials(nthreads);
  std::vector<std::vector<uint8_t>> range_payload(nthreads);
  std::vector<std::pair<int64_t, const char*>> md_faults(nthreads,
                                                         {-1, nullptr});

  auto work = [&](int t) {
    int64_t lo = (int64_t)t * per;
    int64_t hi = std::min(lo + per, n);
    auto& specials = range_specials[t];
    auto& payload = range_payload[t];
    std::vector<uint32_t> enc;  // BAM-encoded cigar, reused across reads
    for (int64_t i = lo; i < hi; i++) {
      int64_t span = ev_off[i + 1] - ev_off[i];
      int64_t seq_len = seq_off[i + 1] - seq_off[i];
      int64_t n_cigar = cigar_off[i + 1] - cigar_off[i];
      mismatches[i] = 0;
      // Defensive: caller-supplied offset arrays must be monotone; a
      // negative span here would otherwise cast to a huge size_t in the
      // memsets below and overwrite the heap.
      if (span < 0 || seq_len < 0 || n_cigar < 0) continue;
      const uint8_t* rseq = seq + seq_off[i];
      const uint8_t* rqual = qual + seq_off[i];

      uint8_t* kinds = ev_kind + ev_off[i];
      uint8_t* bases = ev_base + ev_off[i];
      uint8_t* equals = ev_qual + ev_off[i];
      uint8_t* mdref = ev_mdref + ev_off[i];
      memset(kinds, EV_CLIPPED, (size_t)span);
      memset(bases, 0, (size_t)span);
      memset(equals, (uint8_t)mapq[i], (size_t)span);
      memset(mdref, 'N', (size_t)span);

      enc.clear();
      int64_t cigar_span = 0, read_len_from_cigar = 0;
      for (int64_t c = 0; c < n_cigar; c++) {
        uint32_t op = cigar_op[cigar_off[i] + c];
        uint32_t len = cigar_len[cigar_off[i] + c];
        if (op > 8 || len > 0xFFFFFFFu) { cigar_span = -1; break; }
        enc.push_back((len << 4) | op);
        if (OP_CONSUMES_REF[op] || op == OP_P) cigar_span += len;
        if (OP_CONSUMES_READ[op]) read_len_from_cigar += len;
      }
      // Same gate as the BAM decoder's m.consistent, plus a defensive
      // span check so the provided ev_off can never be overrun.
      bool consistent =
          cigar_span == span && read_len_from_cigar == seq_len;
      if (!consistent) continue;

      // MD expansion runs even for zero-reference-span reads, matching
      // the BAM decoder's phase 2 (expand_md before the span>0 gate);
      // only event building requires a positive span.
      int64_t md_len = md_off[i + 1] - md_off[i];
      int32_t mm = -1;
      if (md_len > 0) {
        const char* fault = expand_md(
            reinterpret_cast<const char*>(md_text + md_off[i]),
            (size_t)md_len, enc.data(), (int32_t)n_cigar, rseq, mdref,
            (size_t)span, &mm);
        if (fault != nullptr) {
          memset(mdref, 'N', (size_t)span);
          mm = -1;
          if (placed != nullptr && placed[i] && md_faults[t].first < 0)
            md_faults[t] = {i, fault};
        }
      }
      mismatches[i] = mm < 0 ? 0 : mm;
      if (span <= 0) continue;

      build_events_at(i, start[i], enc.data(), enc.size(), rseq, rqual,
                      (size_t)seq_len, mapq[i], kinds, bases, equals, mdref,
                      (size_t)span, &specials, &payload);
    }
  };
  if (nthreads <= 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  for (int t = 0; t < nthreads; t++) {
    int64_t base = (int64_t)r->special_payload.size();
    for (Special sp : range_specials[t]) {
      sp.payload_offset += base;
      r->specials.push_back(sp);
    }
    r->special_payload.insert(r->special_payload.end(),
                              range_payload[t].begin(),
                              range_payload[t].end());
  }
  for (const auto& fault : md_faults) {
    if (fault.first < 0) continue;
    *md_why = fault.second;
    return fault.first;
  }
  return -1;
}

// Reads the SAM field [b, e) whole as a decimal integer in [lo, hi]: an
// optional sign, then one digit or more, nothing else. Otherwise false,
// and *why names the field and what is wrong with it.
static bool parse_sam_int(const char* b, const char* e, int64_t lo,
                          int64_t hi, const char* name, int64_t* out,
                          std::string* why) {
  const char* p = b;
  bool negative = false;
  if (p < e && (*p == '-' || *p == '+')) negative = *p++ == '-';
  bool digits = p < e, big = false;
  int64_t v = 0;
  for (; p < e && digits; p++) {
    if (*p < '0' || *p > '9')
      digits = false;
    else if (v > (INT64_MAX - 9) / 10)
      big = true;  // past every range; the digits are still checked
    else
      v = 10 * v + (*p - '0');
  }
  if (!digits) {
    *why = std::string(name) + " \"" + shown(b, e) + "\" is not an integer";
    return false;
  }
  if (negative) v = -v;
  if (big || v < lo || v > hi) {
    *why = std::string(name) + " " + shown(b, e) + " outside " +
           std::to_string(lo) + "-" + std::to_string(hi);
    return false;
  }
  *out = v;
  return true;
}

// The bytes a regular expression of SAMv1 1.4 allows, from its class
// ("0-9A-Za-z": ranges and single bytes, a '-' last stands for itself).
struct ByteSet {
  bool in[256] = {};
  explicit ByteSet(const char* cls) {
    for (const char* p = cls; *p; p++) {
      if (p[1] == '-' && p[2] != '\0') {
        for (int b = (uint8_t)p[0]; b <= (uint8_t)p[2]; b++) in[b] = true;
        p += 2;
      } else {
        in[(uint8_t)*p] = true;
      }
    }
  }
};
const ByteSet kQname("!-?A-~"), kRefFirst("0-9A-Za-z!#$%&+./:;?@^_|~-"),
    kRef("0-9A-Za-z!#$%&*+./:;=?@^_|~-"), kCigar("0-9MIDNSHPX="),
    kSeq("A-Za-z=."), kQual("!-~");

// SEQ and QUAL hold most of a SAM's bytes: a test of their sets that the
// compiler vectorizes passes a clean field before its bytes are looked up.
static bool all_seq(const char* b, const char* e) {
  unsigned ok = 1;
  for (const char* c = b; c < e; c++) {
    const uint8_t x = (uint8_t)*c;
    ok &= ((uint8_t)((x | 0x20) - 'a') < 26) | (x == '=') | (x == '.');
  }
  return ok;
}
static bool all_qual(const char* b, const char* e) {
  unsigned ok = 1;
  for (const char* c = b; c < e; c++) ok &= (uint8_t)(*c - '!') <= '~' - '!';
  return ok;
}

// A mandatory text field: its index, its name, the bytes its first and
// its other bytes may be, the values it may be outside that pattern, and
// a faster test of the whole field where it has one.
struct TextField {
  int index;
  const char* name;
  const ByteSet* first;
  const ByteSet* rest;
  const char* alone;
  bool (*clean)(const char*, const char*);
};
const TextField kTextFields[] = {
    {0, "QNAME", &kQname, &kQname, "", nullptr},
    {2, "RNAME", &kRefFirst, &kRef, "*", nullptr},
    {5, "CIGAR", &kCigar, &kCigar, "*", nullptr},
    {6, "RNEXT", &kRefFirst, &kRef, "*=", nullptr},
    {9, "SEQ", &kSeq, &kSeq, "*", all_seq},
    {10, "QUAL", &kQual, &kQual, "", all_qual},
};

// Parse SAM text into the same columnar Reads the BAM decoder produces
// (header @SQ/@RG, records, then event arrays via fill_events_columns).
// Mirrors gio/sam.py: seq/qual '*' handling, '='/unknown-contig rules,
// RG:Z -> sample, MD:Z tag, 1-based -> 0-based positions.
// text must have a NUL terminator at data()[size] (strtol field parses
// stop at '\t'/'\n' but must not run off the allocation on a truncated
// final line).
// Every numeric field is read whole and held to its range in the SAM spec
// (SAMv1 1.4), every text field to the bytes the spec allows it, every
// optional field to TAG:TYPE:VALUE, and a placed read's MD tag to what
// reads/mdtag.py reads; a field that fails ends the parse, and r->error
// names the field and its 1-based line.
bool parse_sam_text(const std::vector<uint8_t>& text, size_t size, Reads* r,
                    int threads) {
  const char* p = reinterpret_cast<const char*>(text.data());
  const char* end = p + size;
  const int64_t kPosMax = INT32_MAX;  // positions are int32 in the spec
  int64_t line_no = 0;
  auto reject = [&](const char* what, const std::string& why) {
    r->error = std::string("malformed SAM ") + what + " at line " +
               std::to_string(line_no) + ": " + why;
    return false;
  };
  std::string why;

  // ---- header ----
  std::map<std::string, int> ref_index;
  const char* body = p;
  std::string header_text;
  while (body < end && *body == '@') {
    line_no++;
    const char* eol = static_cast<const char*>(
        memchr(body, '\n', (size_t)(end - body)));
    const char* line_end = eol ? eol : end;
    header_text.append(body, (size_t)(line_end - body));
    header_text.push_back('\n');
    if (line_end - body >= 4 && memcmp(body, "@SQ\t", 4) == 0) {
      std::string name;
      int64_t len = 0;
      const char* f = body;
      while (f < line_end) {
        const char* ftab = static_cast<const char*>(
            memchr(f, '\t', (size_t)(line_end - f)));
        const char* fend = ftab ? ftab : line_end;
        if (fend - f > 3 && memcmp(f, "SN:", 3) == 0) {
          name.assign(f + 3, (size_t)(fend - f - 3));
        } else if (fend - f >= 3 && memcmp(f, "LN:", 3) == 0) {
          // The line's CR, where it ends in CRLF, is no part of LN.
          const char* lend = fend;
          if (lend == line_end && lend[-1] == '\r') lend--;
          if (!parse_sam_int(f + 3, lend, 1, kPosMax, "@SQ LN", &len, &why))
            return reject("header", why);
        }
        f = fend + 1;
      }
      if (!name.empty()) {
        ref_index[name] = (int)r->ref_names.size();
        r->ref_names.push_back(name);
        r->ref_lengths.push_back(len);
      }
    }
    body = line_end + 1;
  }
  r->header_text = header_text;
  std::map<std::string, int> rg_to_sample;
  parse_read_groups(header_text, &rg_to_sample, &r->samples);
  int default_sample = -1;

  // ---- records ----
  r->seq_off.push_back(0);
  r->cigar_off.push_back(0);
  r->md_off.push_back(0);
  r->ev_off.push_back(0);

  // op char -> BAM op code; 0xff = invalid
  uint8_t op_code[256];
  memset(op_code, 0xff, sizeof(op_code));
  const char* ops = "MIDNSHP=X";
  for (int i = 0; ops[i]; i++) op_code[(uint8_t)ops[i]] = (uint8_t)i;
  // Per record: placed as gio/sam.py places it (its MD tag is parsed
  // there), and its line.
  std::vector<uint8_t> placed;
  std::vector<int64_t> line_of;

  while (body < end) {
    line_no++;
    const char* eol = static_cast<const char*>(
        memchr(body, '\n', (size_t)(end - body)));
    const char* line_end = eol ? eol : end;
    if (line_end > body && line_end[-1] == '\r') line_end--;
    const char* line = body;
    body = (eol ? eol : end) + 1;
    if (line_end == line) continue;  // blank line

    // tokenize mandatory fields
    const char* f[12];
    const char* fe[12];
    int nf = 0;
    const char* q = line;
    while (nf < 12 && q <= line_end) {
      const char* tab = static_cast<const char*>(
          memchr(q, '\t', (size_t)(line_end - q)));
      f[nf] = q;
      fe[nf] = tab ? tab : line_end;
      q = (tab ? tab : line_end) + 1;
      nf++;
      if (!tab) break;
    }
    if (nf < 11) return reject("record", "fewer than 11 fields");
    for (const TextField& tf : kTextFields) {
      const char* b = f[tf.index];
      const char* e = fe[tf.index];
      if (e - b == 1 && *b != '\0' && strchr(tf.alone, *b)) continue;
      if (tf.clean != nullptr && tf.clean(b, e)) continue;
      for (const char* c = b; c < e; c++) {
        if ((c == b ? tf.first : tf.rest)->in[(uint8_t)*c]) continue;
        char byte[8];
        snprintf(byte, sizeof(byte), "0x%02x", (unsigned)(uint8_t)*c);
        return reject("record", std::string(tf.name) + " \"" + shown(b, e) +
                                    "\" holds byte " + byte + " at " +
                                    std::to_string(c - b) +
                                    ", which SAMv1 excludes");
      }
    }

    int64_t flag, pos, mapq;
    if (!parse_sam_int(f[1], fe[1], 0, 0xFFFF, "FLAG", &flag, &why) ||
        !parse_sam_int(f[3], fe[3], 0, kPosMax, "POS", &pos, &why) ||
        !parse_sam_int(f[4], fe[4], 0, 255, "MAPQ", &mapq, &why))
      return reject("record", why);

    // reference id: '*' or pos<=0 -> unmapped (-1); unknown contigs are
    // appended with length 0 (gio/sam.py keeps such reads mapped)
    int ref_id = -1;
    std::string rname(f[2], (size_t)(fe[2] - f[2]));
    if (!(rname == "*" || rname.empty() || pos <= 0)) {
      auto it = ref_index.find(rname);
      if (it == ref_index.end()) {
        ref_id = (int)r->ref_names.size();
        ref_index[rname] = ref_id;
        r->ref_names.push_back(rname);
        r->ref_lengths.push_back(0);
      } else {
        ref_id = it->second;
      }
    }

    // cigar
    int64_t cigar_count = 0;
    int64_t span = 0;
    if (!(fe[5] - f[5] == 1 && *f[5] == '*')) {
      const char* c = f[5];
      while (c < fe[5]) {
        char* after = nullptr;
        long len = strtol(c, &after, 10);
        if (after == c || after >= fe[5])
          return reject("record", "malformed CIGAR");
        // BAM stores op lengths in 28 bits; reject negatives ('-5M') and
        // overflow here so a hostile length can never become a negative
        // event span (which downstream code casts to size_t).
        if (len < 0 || len > 0xFFFFFFFL)
          return reject("record", "CIGAR op length out of range");
        uint8_t op = op_code[(uint8_t)*after];
        if (op == 0xff) return reject("record", "malformed CIGAR op");
        r->cigar_len.push_back((uint32_t)len);
        r->cigar_op.push_back(op);
        if (OP_CONSUMES_REF[op] || op == OP_P) span += len;
        cigar_count++;
        c = after + 1;
      }
    }
    // Positions are int32 in the spec; a larger end would size the event
    // arrays past any memory (the BAM parser's bound, for unplaced reads
    // too).
    if (std::max<int64_t>(pos - 1, 0) + span > kPosMax)
      return reject("record", "POS " + std::to_string(pos) + " + CIGAR span " +
                                  std::to_string(span) + " past 2^31 - 1");

    // mate fields
    int mate_ref = -1;
    if (fe[6] - f[6] == 1 && *f[6] == '=') {
      mate_ref = ref_id;
    } else if (!(fe[6] - f[6] == 1 && *f[6] == '*')) {
      auto it = ref_index.find(std::string(f[6], (size_t)(fe[6] - f[6])));
      if (it != ref_index.end()) mate_ref = it->second;
    }
    int64_t pnext, tlen;
    if (!parse_sam_int(f[7], fe[7], 0, kPosMax, "PNEXT", &pnext, &why) ||
        !parse_sam_int(f[8], fe[8], -kPosMax, kPosMax, "TLEN", &tlen, &why))
      return reject("record", why);

    // seq / qual ('*' -> empty / zeros)
    int64_t l_seq = 0;
    if (!(fe[9] - f[9] == 1 && *f[9] == '*')) {
      l_seq = fe[9] - f[9];
      r->seq.insert(r->seq.end(), f[9], fe[9]);
      if (fe[10] - f[10] == 1 && *f[10] == '*') {
        r->qual.insert(r->qual.end(), (size_t)l_seq, 0);
      } else {
        if (fe[10] - f[10] != l_seq)
          return reject("record", "QUAL length != SEQ length");
        // Phred+33, every byte in '!'-'~' (checked above).
        for (const char* qq = f[10]; qq < fe[10]; qq++)
          r->qual.push_back((uint8_t)(*qq - 33));
      }
    }

    // optional tags: MD:Z and RG:Z
    int64_t md_len = 0;
    int sample = -1;
    if (nf == 12) {
      const char* t = f[11];
      const char* tags_end = line_end;
      while (t < tags_end) {
        const char* tab = static_cast<const char*>(
            memchr(t, '\t', (size_t)(tags_end - t)));
        const char* te = tab ? tab : tags_end;
        // TAG:TYPE:VALUE, or the line is no SAM record: a line that joins
        // two records reads the second one's fields here.
        if (!(te - t >= 5 && ascii_letter(t[0]) &&
              (ascii_letter(t[1]) || (t[1] >= '0' && t[1] <= '9')) &&
              t[2] == ':' && t[3] != '\0' && strchr("AcCsSiIfZHB", t[3]) &&
              t[4] == ':'))
          return reject("record", "optional field \"" + shown(t, te) +
                                      "\" is not TAG:TYPE:VALUE");
        if (te - t > 5 && memcmp(t, "MD:Z:", 5) == 0 && md_len == 0) {
          // First MD:Z only: appending repeats while md_len keeps just the
          // last would desynchronize md_off for every later read.
          md_len = te - t - 5;
          r->md_text.insert(r->md_text.end(), t + 5, te);
        } else if (te - t > 5 && memcmp(t, "RG:Z:", 5) == 0) {
          auto it = rg_to_sample.find(std::string(t + 5, (size_t)(te - t - 5)));
          if (it != rg_to_sample.end()) sample = it->second;
        }
        t = te + 1;
      }
    }
    if (sample < 0) {
      if (default_sample < 0) {
        default_sample = (int)r->samples.size();
        r->samples.push_back("default");
      }
      sample = default_sample;
    }

    int64_t start0 = pos - 1;
    r->ref_id.push_back(ref_id);
    r->start.push_back(start0);
    r->end.push_back(start0 + span);
    r->mapq.push_back(mapq);
    r->flags.push_back((uint16_t)flag);
    r->mate_ref_id.push_back(mate_ref);
    r->mate_start.push_back(pnext - 1);
    r->tlen.push_back(tlen);
    r->mismatches.push_back(0);
    r->sample_id.push_back(sample);
    r->seq_off.push_back(r->seq_off.back() + l_seq);
    r->cigar_off.push_back(r->cigar_off.back() + cigar_count);
    r->md_off.push_back(r->md_off.back() + md_len);
    r->ev_off.push_back(r->ev_off.back() + span);
    placed.push_back(!(flag & 4) && ref_id >= 0);
    line_of.push_back(line_no);
  }

  // ---- events (same phase-2 code as the BAM decoder) ----
  int64_t n = (int64_t)r->start.size();
  int64_t total = r->ev_off.back();
  r->ev_kind.resize((size_t)total);
  r->ev_base.resize((size_t)total);
  r->ev_qual.resize((size_t)total);
  r->ev_mdref.resize((size_t)total);
  const char* md_why = nullptr;
  const int64_t bad = fill_events_columns(
      n, r->start.data(), r->mapq.data(), r->seq_off.data(), r->seq.data(),
      r->qual.data(), r->cigar_off.data(), r->cigar_len.data(),
      r->cigar_op.data(), r->md_off.data(), r->md_text.data(),
      r->ev_off.data(), threads, r->ev_kind.data(), r->ev_base.data(),
      r->ev_qual.data(), r->ev_mdref.data(), r->mismatches.data(), r,
      placed.data(), &md_why);
  if (bad >= 0) {
    line_no = line_of[bad];
    const char* md = reinterpret_cast<const char*>(r->md_text.data());
    return reject("record", "MD tag \"" +
                                shown(md + r->md_off[bad],
                                      md + r->md_off[bad + 1]) +
                                "\" " + md_why);
  }
  return true;
}

}  // namespace

extern "C" {

// Build event arrays for reads supplied as columnar buffers (the
// object-read ingest path: Python assembles the cheap seq/qual/cigar/MD
// columns, this fills the expensive per-locus event arrays with the SAME
// code the BAM decoder uses — mirrors pack/events.py read_pileup_events).
// Outputs ev_kind/ev_base/ev_qual/ev_mdref are caller-allocated, sized
// ev_off[n]; mismatches is caller-allocated [n]. Returns a Reads* handle
// carrying ONLY the specials + payload (fetch via guac_num_specials /
// guac_specials / guac_special_payload; free with guac_free_reads).
void* guac_build_events(int64_t n, const int64_t* start, const int32_t* mapq,
                        const int64_t* seq_off, const uint8_t* seq,
                        const uint8_t* qual, const int64_t* cigar_off,
                        const uint32_t* cigar_len, const uint8_t* cigar_op,
                        const int64_t* md_off, const uint8_t* md_text,
                        const int64_t* ev_off, int threads,
                        uint8_t* ev_kind, uint8_t* ev_base, uint8_t* ev_qual,
                        uint8_t* ev_mdref, int32_t* mismatches) {
  return guarded([&]() -> void* {
    std::unique_ptr<Reads> r(new Reads());
    fill_events_columns(n, start, mapq, seq_off, seq, qual, cigar_off,
                        cigar_len, cigar_op, md_off, md_text, ev_off, threads,
                        ev_kind, ev_base, ev_qual, ev_mdref, mismatches,
                        r.get());
    return r.release();
  });
}

// Decode a SAM text file into the same columnar handle as guac_decode_bam.
void* guac_decode_sam(const char* path, int threads) {
  return guarded([&]() -> void* {
    std::vector<uint8_t> raw;
    if (!read_file(path, &raw)) return decode_failed("cannot read the file");
    size_t size = raw.size();
    raw.push_back(0);  // strtol guard for a truncated final line
    std::unique_ptr<Reads> r(new Reads());
    if (!parse_sam_text(raw, size, r.get(), threads))
      return decode_failed(r->error);
    return r.release();
  });
}

int64_t guac_num_specials(void* h) {
  return static_cast<Reads*>(h)->specials.size();
}
// Fill caller-allocated arrays describing specials.
void guac_specials(void* h, int64_t* read_index, int64_t* offset,
                   int32_t* kind, int64_t* payload_offset,
                   int64_t* payload_len, int32_t* qual) {
  Reads* r = static_cast<Reads*>(h);
  for (size_t i = 0; i < r->specials.size(); i++) {
    read_index[i] = r->specials[i].read_index;
    offset[i] = r->specials[i].offset;
    kind[i] = r->specials[i].kind;
    payload_offset[i] = r->specials[i].payload_offset;
    payload_len[i] = r->specials[i].payload_len;
    qual[i] = r->specials[i].qual;
  }
}

}  // extern "C"
