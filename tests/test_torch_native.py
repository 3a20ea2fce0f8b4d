"""The port's own copy of the native host runtime (runtime/csrc/).

guacamole_tpu_torch builds its BGZF/BAM/SAM decoder and tile packer from
its own copy of native/guac_runtime.cpp and native/guac_pack.cpp, shipped
in the package. This file holds that copy:

- equal to native/*.cpp after the package rename, outside the hunks listed
  in REPAIRS;
- free of out-of-bounds reads on malformed input: a standalone harness
  (tests/native_decode_harness.cpp) built from the copy with
  AddressSanitizer runs guac_decode_bam, guac_decode_bam_chunks (one
  chunk over the whole file, .bai chunks, and chunks that start inside a
  block) and guac_decode_sam over crafted, truncated and mutated inputs,
  with no sanitizer report, and the whole-file decoder returns no handle
  wherever the input is malformed (malformed records:
  tests/test_torch_native_records.py);
- free of data races in the packer and the event builder: a second
  harness (tests/native_pack_harness.cpp) built from the copy with
  ThreadSanitizer packs the fixture's contigs on the packer's threads in
  each of its four modes (whole contigs for the CSR mode, windows for the
  dense ones) and rebuilds the event arrays with guac_build_events on 16
  threads, with no sanitizer report;
- equal to the JAX package's library on well-formed input, column for
  column (whole file, .bai chunks, SAM);
- enough on its own: the package, copied alone into a directory with no
  repo around it, builds its library from its own sources and decodes.
"""

import dataclasses
import difflib
import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from guacamole_tpu.runtime import columnar as jax_columnar
from guacamole_tpu.utils.simulate import make_scale_fixture
from guacamole_tpu_torch.callers.streaming import ensure_bam_index
from guacamole_tpu_torch.gio.bai import BamIndex, optimize_chunks
from guacamole_tpu_torch.runtime import columnar as port_columnar
from guacamole_tpu_torch.runtime import native as port_native
import native_build
from test_torch_host_copies import _REWRITE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(ROOT, "guacamole_tpu_torch")

# The copy's departures from native/*.cpp: (file, reason, the original's
# lines, the copy's lines), in file order. Each BGZF header walk is bounded
# by its buffer, each field of a BAM or SAM record by its block and by its
# range in the spec, and a .bai chunk that cannot be walked to its end is
# refused; every refusal says why. On well-formed input none of the checks
# fails, so the outputs are the original's. The packer
# reads its table of long allele keys under the lock its writers hold,
# which orders the same reads. A later change to the copy adds its hunks
# here, each with its reason.
_SCAN = "scan_bgzf_blocks"
_AT = "BgzfStream::inflate_at"
_CHUNKS = "decode_bam_chunks"
_PARSE = "parse_bam_records"
_SAM = "parse_sam_text"
_PACK = "guac_pack_tile, the CSR pass"
REPAIRS = (
    ("guac_runtime.cpp",
     "the handles the decoders build are held by std::unique_ptr",
     "",
     "#include <memory>\n"),
    ("guac_runtime.cpp",
     "the error channel: g_last_error keeps why a decoder returned no handle "
     "(guac_last_error); guarded keeps an exception (std::bad_alloc from a "
     "size the input gave) from crossing the C ABI, where it aborts the "
     "process",
     "",
     "\n"
     "// Why the last decode on this thread returned no handle, for\n"
     "// guac_last_error(); empty after a decode that succeeded.\n"
     "thread_local std::string g_last_error;\n"
     "\n"
     "static std::nullptr_t decode_failed(const std::string& why) {\n"
     "  g_last_error = why.empty() ? \"decode failed\" : why;\n"
     "  return nullptr;\n"
     "}\n"
     "\n"
     "// Runs the body of a C entry: an exception (std::bad_alloc from a"
     " size\n"
     "// the input gave) must not cross the C ABI, where it aborts the"
     " process.\n"
     "template <class Body>\n"
     "static void* guarded(Body body) {\n"
     "  g_last_error.clear();\n"
     "  try {\n"
     "    return body();\n"
     "  } catch (const std::bad_alloc&) {\n"
     "    return decode_failed(\"out of memory\");\n"
     "  } catch (const std::exception& e) {\n"
     "    return decode_failed(e.what());\n"
     "  } catch (...) {\n"
     "    return decode_failed(\"unknown exception\");\n"
     "  }\n"
     "}\n"),
    ("guac_runtime.cpp",
     "ISIZE above 64 KiB is corrupt, not a size to allocate",
     "",
     "// A BGZF block inflates to at most 64 KiB (SAM/BAM spec 4.1); a larger\n"
     "// ISIZE is corrupt input, not a size to allocate.\n"
     "static const uint32_t kBgzfMaxBlock = 65536;\n\n"),
    ("guac_runtime.cpp",
     f"{_SCAN}: XLEN must not run past the buffer (read past it at :76)",
     "",
     "    // Every header walk stays inside its buffer: the extra field, each\n"
     "    // subfield and the block's footer.\n"
     "    if (offset + 12 + xlen > n) return false;\n"),
    ("guac_runtime.cpp",
     f"{_SCAN}: a subfield must end inside the extra field (the BSIZE "
     "memcpy read past the buffer at :81)",
     "",
     "      if (pos + 4 + slen > end) return false;\n"),
    ("guac_runtime.cpp",
     f"{_SCAN}: BSIZE must cover header and footer (ISIZE was read before "
     "the block, the inflate got a negative size)",
     "    if (bsize == 0 || offset + bsize > n) return false;\n",
     "    if (bsize < 12 + (size_t)xlen + 8 || offset + bsize > n) "
     "return false;\n"),
    ("guac_runtime.cpp", f"{_SCAN}: ISIZE bound",
     "",
     "    if (isize > kBgzfMaxBlock) return false;\n"),
    ("guac_runtime.cpp",
     "expand_md: an op code above 8 indexed past the 9-entry op tables "
     "(native/guac_runtime.cpp:378)",
     "",
     "    if (op > OP_X) return false;  // no op of the spec; the tables hold"
     " 9\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: a failed check names the field and the record's offset in "
     "the inflated stream, and ends the parse: phase 2 sees only checked "
     "records",
     "",
     "  // Every field is bounded by its record's block before it is used. A\n"
     "  // record that fails a check ends the parse: r->error names the"
     " field\n"
     "  // and the record's offset in the inflated stream, and phase 2 never\n"
     "  // sees a record that was not checked.\n"
     "  auto reject = [&](size_t at, const std::string& why) {\n"
     "    r->error = \"malformed BAM record at inflated byte \" +\n"
     "               std::to_string(at) + \": \" + why;\n"
     "    return false;\n"
     "  };\n"
     "\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: a record whose block_size is cut by the end of the data is "
     "refused, not dropped",
     "  while (pos < end_pos && pos + 4 <= u.size()) {\n",
     "  while (pos < end_pos) {\n"
     "    const size_t at = pos;\n"
     "    if (pos + 4 > u.size())\n"
     "      return reject(at, \"block_size cut by the end of the data\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: block_size must cover the 32 bytes of fixed fields (a "
     "block_size of 8 read 32 bytes and was accepted, :584) and end inside "
     "the data (an overhanging record was dropped in silence)",
     "    if (block_size <= 0 || pos + 4 + block_size > u.size()) break;\n",
     "    if (block_size < 32)\n"
     "      return reject(at, \"block_size \" + std::to_string(block_size) +\n"
     "                            \" below the 32 bytes of fixed fields\");\n"
     "    if (pos + 4 + (size_t)block_size > u.size())\n"
     "      return reject(at, \"block_size \" + std::to_string(block_size) +\n"
     "                            \" past the end of the data\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: ref_id and next_ref must be -1 or index the header's "
     "references, pos and next_pos at least -1 (an id past the header "
     "stayed in the columns, :673 and :678: is_mapped_mask counted the "
     "read mapped and to_read raised IndexError, where gio/bam.py maps "
     "the id to '*')",
     "",
     "    // A reference id indexes the header's list, -1 for none; a"
     " position\n"
     "    // is 0-based, -1 for none.\n"
     "    const int32_t n_ref = (int32_t)r->ref_names.size();\n"
     "    if (ref_id < -1 || ref_id >= n_ref)\n"
     "      return reject(at, \"ref_id \" + std::to_string(ref_id) +\n"
     "                            \" outside the header's \" +"
     " std::to_string(n_ref) +\n"
     "                            \" references\");\n"
     "    if (next_ref < -1 || next_ref >= n_ref)\n"
     "      return reject(at, \"next_ref \" + std::to_string(next_ref) +\n"
     "                            \" outside the header's \" +"
     " std::to_string(n_ref) +\n"
     "                            \" references\");\n"
     "    if (pos0 < -1)\n"
     "      return reject(at, \"pos \" + std::to_string(pos0) + \" below"
     " -1\");\n"
     "    if (next_pos < -1)\n"
     "      return reject(at, \"next_pos \" + std::to_string(next_pos) + \""
     " below -1\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: l_seq >= 0, and l_read_name, n_cigar and l_seq must fit "
     "block_size (phase 2 read past the heap buffer, :744-761)",
     "",
     "    if (l_seq < 0)\n"
     "      return reject(at, \"negative l_seq \" + std::to_string(l_seq));\n"
     "    // At most 32 + 255 + 4 * 65535 + 1.5 * (2^31 - 1): no overflow.\n"
     "    const size_t need = 32 + (size_t)l_read_name + 4 * (size_t)n_cigar"
     " +\n"
     "                        ((size_t)l_seq + 1) / 2 + (size_t)l_seq;\n"
     "    if (need > (size_t)block_size)\n"
     "      return reject(at, \"l_read_name \" + std::to_string(l_read_name)"
     " +\n"
     "                            \", n_cigar \" + std::to_string(n_cigar) +\n"
     "                            \" and l_seq \" + std::to_string(l_seq) +"
     " \" need \" +\n"
     "                            std::to_string(need) + \" bytes, block_size"
     " is \" +\n"
     "                            std::to_string(block_size));\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}, tag scan: a B tag's subtype and count must lie in the block "
     "(read past it at :640)",
     "",
     "            if (tp + 5 > rec_len)\n"
     "              return reject(at, \"B tag header cut by block_size\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}, tag scan: a B tag's elements must fit the block",
     "",
     "            // A uint32 count times at most 4 fits a 64-bit size_t.\n"
     "            if ((uint64_t)count * esize > rec_len - (tp + 5))\n"
     "              return reject(at, \"B tag count \" +"
     " std::to_string(count) +\n"
     "                                    \" past block_size\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: a CIGAR op code above 8 indexed past the 9-entry op tables "
     "(:669)",
     "",
     "      if (op > OP_X)\n"
     "        return reject(at, \"CIGAR op code \" + std::to_string(op) + \""
     " above 8\");\n"),
    ("guac_runtime.cpp",
     f"{_PARSE}: pos + CIGAR span must stay an int32 position, and the span "
     "of an unmapped record too (a larger span sized the event arrays past "
     "any memory)",
     "",
     "    // Positions are int32 in the BAM spec; a larger end would size"
     " the\n"
     "    // event arrays past any memory. The span sizes them for an"
     " unmapped\n"
     "    // record (pos -1) too.\n"
     "    if ((int64_t)std::max(pos0, 0) + span > INT32_MAX)\n"
     "      return reject(at, \"pos \" + std::to_string(pos0) + \" + CIGAR"
     " span \" +\n"
     "                            std::to_string(span) + \" past 2^31 -"
     " 1\");\n"),
    ("guac_runtime.cpp",
     f"{_AT}: a subfield must end inside the extra field",
     "",
     "      if (pos + 4 + slen > xlen) return false;\n"),
    ("guac_runtime.cpp",
     f"{_AT}: BSIZE must cover header and footer",
     "    if (bs == 0 || coffset + bs > fsize) return false;\n",
     "    if (bs < 12 + (size_t)xlen + 8 || coffset + bs > fsize) "
     "return false;\n"),
    ("guac_runtime.cpp", f"{_AT}: ISIZE bound",
     "",
     "    if (isize > kBgzfMaxBlock) return false;\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: a refusal says why",
     "  if (!stream.open(path)) return nullptr;\n",
     "  if (!stream.open(path)) return decode_failed(\"cannot open the"
     " file\");\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: the handle is freed on every refusal and exception",
     "  Reads* r = new Reads();\n",
     "  std::unique_ptr<Reads> r(new Reads());\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: the header parse fills the held handle",
     "    rc = parse_bam_header(hdr_u, hdr_u.size(), r, &rg_to_sample,\n",
     "    rc = parse_bam_header(hdr_u, hdr_u.size(), r.get(), "
     "&rg_to_sample,\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: a refused header says why",
     "  if (rc != 0) {\n"
     "    delete r;\n"
     "    return nullptr;\n"
     "  }\n",
     "  if (rc != 0)\n"
     "    return decode_failed(r->error.empty() ? \"truncated BAM header\" :"
     " r->error);\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: a chunk that cannot be walked is refused, naming its "
     "index and its two virtual offsets",
     "",
     "    // A chunk that cannot be walked is refused, naming it: a"
     " decode that\n"
     "    // kept the records before the fault would lose reads in silence.\n"
     "    auto refuse = [&](const std::string& why) {\n"
     "      return decode_failed(\"chunk \" + std::to_string(c) + \" [\" +\n"
     "                           std::to_string(vbeg[c]) + \", \" +\n"
     "                           std::to_string(vend[c]) + \"): \" + why);\n"
     "    };\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: a chunk that starts at or past the end of the file is "
     "refused (it was skipped at :954, its reads lost with exit code 0)",
     "    if ((size_t)c0 >= stream.fsize) continue;\n",
     "    if ((size_t)c0 >= stream.fsize)\n"
     "      return refuse(\"starts at compressed offset \" +"
     " std::to_string(c0) +\n"
     "                    \", at or past the end of the file (\" +\n"
     "                    std::to_string(stream.fsize) + \" bytes)\");\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: a failed fseek or a short fread is refused (neither was "
     "checked, :960-961)",
     "    fseek(stream.f, (long)c0, SEEK_SET);\n"
     "    cbuf.resize(fread(cbuf.data(), 1, cbuf.size(), stream.f));\n",
     "    if (fseek(stream.f, (long)c0, SEEK_SET) != 0)\n"
     "      return refuse(\"cannot seek to compressed offset \" +"
     " std::to_string(c0));\n"
     "    if (fread(cbuf.data(), 1, cbuf.size(), stream.f) != cbuf.size())\n"
     "      return refuse(\"cannot read \" + std::to_string(cbuf.size()) +\n"
     "                    \" bytes at compressed offset \" +"
     " std::to_string(c0));\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: the inflated size of the chunk's end block, which bounds "
     "its end offset",
     "    size_t loff = 0, uoff = 0;\n",
     "    size_t loff = 0, uoff = 0, end_isize = 0;\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: XLEN must not run past the chunk's buffer (read past "
     "it at :973)",
     "",
     "      if (loff + 12 + xlen > cbuf.size()) break;\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: a subfield must end inside the extra field (the BSIZE "
     "memcpy read past the buffer at :978)",
     "",
     "        if (pos + 4 + slen > hend) {\n"
     "          bsize = 0;  // a subfield overruns the header: malformed\n"
     "          break;\n"
     "        }\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: BSIZE must cover header and footer",
     "      if (bsize == 0 || loff + bsize > cbuf.size()) break;\n",
     "      if (bsize < 12 + (size_t)xlen + 8 || loff + bsize > cbuf.size()) "
     "break;\n"),
    ("guac_runtime.cpp", f"{_CHUNKS}: ISIZE bound",
     "",
     "      if (isize > kBgzfMaxBlock) break;\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: the end block's inflated size",
     "",
     "          end_isize = isize;\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: an end offset inside a block is refused (the chunk was "
     "cut at the block before it, :992-996)",
     "          // End voffset fell between blocks (defensive): stop here.\n"
     "          have_end = true;\n"
     "          slack_done = true;\n"
     "          uend = uoff;\n"
     "          break;\n",
     "          return refuse(\"ends at compressed offset \" +"
     " std::to_string(c1) +\n"
     "                        \", where no block starts\");\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: a walk that stops at a block header it cannot read, "
     "before the chunk's end block and short of the end of the file, is "
     "refused (the chunk kept the blocks before it, :966-983, 1034: a BAM "
     "cut inside a block, or the .bai of another file, lost reads with "
     "exit code 0); a start or end offset past its block's inflated "
     "data is refused (clamped at :1035-1036)",
     "",
     "    // The walk must reach the block at c1, or the end of the file"
     " (the EOF\n"
     "    // convention below); it stops before either only at a block"
     " header it\n"
     "    // cannot read: a cut or corrupt file, or a .bai of another file.\n"
     "    if (!have_end && (size_t)c0 + loff != stream.fsize)\n"
     "      return refuse(\"no readable block header at compressed offset"
     " \" +\n"
     "                    std::to_string((size_t)c0 + loff) +\n"
     "                    \", before the chunk's end block at \" +"
     " std::to_string(c1));\n"
     "    if (u0 > lbs[0].usize)\n"
     "      return refuse(\"starts at byte \" + std::to_string(u0) +\n"
     "                    \" of a block that inflates to \" +\n"
     "                    std::to_string(lbs[0].usize));\n"
     "    if (have_end && u1 > end_isize)\n"
     "      return refuse(\"ends at byte \" + std::to_string(u1) +\n"
     "                    \" of a block that inflates to \" +\n"
     "                    std::to_string(end_isize));\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: a block that does not inflate says why, naming the "
     "chunk",
     "      if (!ok.load()) {\n"
     "        delete r;\n"
     "        return nullptr;\n"
     "      }\n",
     "      if (!ok.load()) return refuse(\"malformed BGZF block\");\n"),
    ("guac_runtime.cpp",
     f"{_CHUNKS}: the EOF convention holds only for a walk that reached "
     "the end of the file",
     "    // End voffset past the last data block (EOF convention): the"
     " chunk\n"
     "    // covers everything walked.\n",
     "    // End voffset past the last data block (EOF convention): the walk\n"
     "    // reached the end of the file, and the chunk covers everything"
     " walked.\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: a refused record fails the decode, naming the "
     "chunk (the parser's return was ignored at :1039, the chunk cut "
     "short in silence)",
     "    parse_bam_records(u, ustart, uend, r, rg_to_sample,"
     " &default_sample,\n"
     "                      threads);\n",
     "    if (!parse_bam_records(u, ustart, uend, r.get(), rg_to_sample,\n"
     "                           &default_sample, threads))\n"
     "      return refuse(r->error);\n"),
    ("guac_runtime.cpp",
     "decode_bam_chunks: the caller takes the handle",
     "  return r;\n",
     "  return r.release();\n"),
    ("guac_runtime.cpp",
     "guac_last_error: the reason of the last refusal on the calling thread, "
     "for the bindings",
     "",
     "// Why the last guac_decode_bam, guac_decode_bam_chunks or"
     " guac_decode_sam\n"
     "// on the calling thread returned no handle (empty after a success).\n"
     "const char* guac_last_error() { return g_last_error.c_str(); }\n"
     "\n"),
    ("guac_runtime.cpp",
     "guac_decode_bam: a refusal says why; an exception is a refusal",
     "  std::vector<uint8_t> raw;\n"
     "  if (!read_file(path, &raw)) return nullptr;\n"
     "  std::vector<uint8_t> uncompressed;\n"
     "  if (!bgzf_decompress(raw, &uncompressed, threads)) return nullptr;\n"
     "  Reads* r = new Reads();\n"
     "  if (!parse_bam(uncompressed, r, threads)) {\n"
     "    delete r;\n"
     "    return nullptr;\n"
     "  }\n"
     "  return r;\n",
     "  return guarded([&]() -> void* {\n"
     "    std::vector<uint8_t> raw;\n"
     "    if (!read_file(path, &raw)) return decode_failed(\"cannot read the"
     " file\");\n"
     "    std::vector<uint8_t> uncompressed;\n"
     "    if (!bgzf_decompress(raw, &uncompressed, threads))\n"
     "      return decode_failed(\"malformed BGZF block\");\n"
     "    std::unique_ptr<Reads> r(new Reads());\n"
     "    if (!parse_bam(uncompressed, r.get(), threads))\n"
     "      return decode_failed(r->error);\n"
     "    return r.release();\n"
     "  });\n"),
    ("guac_runtime.cpp",
     "guac_decode_bam_chunks: an exception is a refusal",
     "  return decode_bam_chunks(path, threads, n_chunks, vbeg, vend);\n",
     "  return guarded([&]() -> void* {\n"
     "    return decode_bam_chunks(path, threads, n_chunks, vbeg, vend);\n"
     "  });\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: shown and parse_sam_int read a numeric field whole and hold "
     "it to its range (strtol read '12abc' as 12 and 'abc' as 0, and "
     "nothing bounded the values); a reason shows the field printable",
     "",
     "// [b, e) for a reason: printable ASCII, anything else as '?', at"
     " most 40\n"
     "// characters (a reason is one line of text, tab-free).\n"
     "static std::string shown(const char* b, const char* e) {\n"
     "  std::string out;\n"
     "  for (const char* p = b; p < e && out.size() < 40; p++)\n"
     "    out.push_back(*p >= ' ' && *p <= '~' ? *p : '?');\n"
     "  if (e - b > 40) out += \"...\";\n"
     "  return out;\n"
     "}\n"
     "\n"
     "// Reads the SAM field [b, e) whole as a decimal integer in [lo,"
     " hi]: an\n"
     "// optional sign, then one digit or more, nothing else. Otherwise"
     " false,\n"
     "// and *why names the field and what is wrong with it.\n"
     "static bool parse_sam_int(const char* b, const char* e, int64_t lo,\n"
     "                          int64_t hi, const char* name, int64_t* out,\n"
     "                          std::string* why) {\n"
     "  const char* p = b;\n"
     "  bool negative = false;\n"
     "  if (p < e && (*p == '-' || *p == '+')) negative = *p++ == '-';\n"
     "  bool digits = p < e, big = false;\n"
     "  int64_t v = 0;\n"
     "  for (; p < e && digits; p++) {\n"
     "    if (*p < '0' || *p > '9')\n"
     "      digits = false;\n"
     "    else if (v > (INT64_MAX - 9) / 10)\n"
     "      big = true;  // past every range; the digits are still checked\n"
     "    else\n"
     "      v = 10 * v + (*p - '0');\n"
     "  }\n"
     "  if (!digits) {\n"
     "    *why = std::string(name) + \" \\\"\" + shown(b, e) + \"\\\" is not an"
     " integer\";\n"
     "    return false;\n"
     "  }\n"
     "  if (negative) v = -v;\n"
     "  if (big || v < lo || v > hi) {\n"
     "    *why = std::string(name) + \" \" + shown(b, e) + \" outside \" +\n"
     "           std::to_string(lo) + \"-\" + std::to_string(hi);\n"
     "    return false;\n"
     "  }\n"
     "  *out = v;\n"
     "  return true;\n"
     "}\n"
     "\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: what it checks",
     "",
     "// Every numeric field is read whole and held to its range in the"
     " SAM spec\n"
     "// (SAMv1 1.4); a field that fails ends the parse, and r->error"
     " names the\n"
     "// field and its 1-based line.\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a refusal names the field and its 1-based line",
     "",
     "  const int64_t kPosMax = INT32_MAX;  // positions are int32 in the"
     " spec\n"
     "  int64_t line_no = 0;\n"
     "  auto reject = [&](const char* what, const std::string& why) {\n"
     "    r->error = std::string(\"malformed SAM \") + what + \" at line \""
     " +\n"
     "               std::to_string(line_no) + \": \" + why;\n"
     "    return false;\n"
     "  };\n"
     "  std::string why;\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: header lines are counted",
     "",
     "    line_no++;\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: @SQ LN read whole, in [1, 2^31 - 1], without the CR of a "
     "CRLF line (strtoll read 'abc' as 0, :1272; an empty LN: was "
     "skipped)",
     "        } else if (fend - f > 3 && memcmp(f, \"LN:\", 3) == 0) {\n"
     "          len = strtoll(f + 3, nullptr, 10);\n",
     "        } else if (fend - f >= 3 && memcmp(f, \"LN:\", 3) == 0) {\n"
     "          // The line's CR, where it ends in CRLF, is no part of LN.\n"
     "          const char* lend = fend;\n"
     "          if (lend == line_end && lend[-1] == '\\r') lend--;\n"
     "          if (!parse_sam_int(f + 3, lend, 1, kPosMax, \"@SQ LN\","
     " &len, &why))\n"
     "            return reject(\"header\", why);\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: record lines are counted",
     "",
     "    line_no++;\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: the field count refusal names its line",
     "    if (nf < 11) {\n"
     "      r->error = \"malformed SAM record (fewer than 11 fields)\";\n"
     "      return false;\n"
     "    }\n",
     "    if (nf < 11) return reject(\"record\", \"fewer than 11 fields\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: FLAG in [0, 2^16 - 1], POS in [0, 2^31 - 1], MAPQ in [0, "
     "255], each read whole (:1329-1331: FLAG was cast to uint16 at "
     ":1451, a MAPQ of 300 became 44 in the events at :1180, a POS of "
     "'abc' made the read unmapped at :1337)",
     "    int flag = (int)strtol(f[1], nullptr, 10);\n"
     "    int64_t pos = strtoll(f[3], nullptr, 10);\n"
     "    int mapq = (int)strtol(f[4], nullptr, 10);\n",
     "    int64_t flag, pos, mapq;\n"
     "    if (!parse_sam_int(f[1], fe[1], 0, 0xFFFF, \"FLAG\", &flag, &why)"
     " ||\n"
     "        !parse_sam_int(f[3], fe[3], 0, kPosMax, \"POS\", &pos, &why)"
     " ||\n"
     "        !parse_sam_int(f[4], fe[4], 0, 255, \"MAPQ\", &mapq, &why))\n"
     "      return reject(\"record\", why);\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a CIGAR refusal names its line",
     "        if (after == c || after >= fe[5]) {\n"
     "          r->error = \"malformed CIGAR\";\n"
     "          return false;\n"
     "        }\n",
     "        if (after == c || after >= fe[5])\n"
     "          return reject(\"record\", \"malformed CIGAR\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a CIGAR refusal names its line",
     "        if (len < 0 || len > 0xFFFFFFFL) {\n"
     "          r->error = \"CIGAR op length out of range\";\n"
     "          return false;\n"
     "        }\n",
     "        if (len < 0 || len > 0xFFFFFFFL)\n"
     "          return reject(\"record\", \"CIGAR op length out of range\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a CIGAR refusal names its line",
     "        if (op == 0xff) {\n"
     "          r->error = \"malformed CIGAR op\";\n"
     "          return false;\n"
     "        }\n",
     "        if (op == 0xff) return reject(\"record\", \"malformed CIGAR"
     " op\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: max(POS - 1, 0) + CIGAR span bounded by 2^31 - 1, as in the "
     "BAM parser (ten ops of 2^28 - 1 bases sized the event arrays at "
     "2.7 GB, :1466)",
     "",
     "    // Positions are int32 in the spec; a larger end would size the"
     " event\n"
     "    // arrays past any memory (the BAM parser's bound, for unplaced"
     " reads\n"
     "    // too).\n"
     "    if (std::max<int64_t>(pos - 1, 0) + span > kPosMax)\n"
     "      return reject(\"record\", \"POS \" + std::to_string(pos) + \" +"
     " CIGAR span \" +\n"
     "                                  std::to_string(span) + \" past"
     " 2^31 - 1\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: PNEXT in [0, 2^31 - 1] and TLEN in [-2^31 + 1, 2^31 - 1], "
     "each read whole (:1389-1390)",
     "    int64_t pnext = strtoll(f[7], nullptr, 10);\n"
     "    int32_t tlen = (int32_t)strtol(f[8], nullptr, 10);\n",
     "    int64_t pnext, tlen;\n"
     "    if (!parse_sam_int(f[7], fe[7], 0, kPosMax, \"PNEXT\", &pnext,"
     " &why) ||\n"
     "        !parse_sam_int(f[8], fe[8], -kPosMax, kPosMax, \"TLEN\","
     " &tlen, &why))\n"
     "      return reject(\"record\", why);\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a QUAL refusal names its line",
     "        if (fe[10] - f[10] != l_seq) {\n"
     "          r->error = \"QUAL length != SEQ length\";\n"
     "          return false;\n"
     "        }\n",
     "        if (fe[10] - f[10] != l_seq)\n"
     "          return reject(\"record\", \"QUAL length != SEQ length\");\n"),
    ("guac_runtime.cpp",
     f"{_SAM}: a QUAL refusal names its line",
     "          if ((uint8_t)*qq < 33) {\n"
     "            r->error = \"QUAL character below '!' (corrupt quality"
     " string)\";\n"
     "            return false;\n"
     "          }\n",
     "          if ((uint8_t)*qq < 33)\n"
     "            return reject(\"record\",\n"
     "                          \"QUAL character below '!' (corrupt"
     " quality string)\");\n"),
    ("guac_runtime.cpp",
     "guac_build_events: an exception returns no handle",
     "  Reads* r = new Reads();\n"
     "  fill_events_columns(n, start, mapq, seq_off, seq, qual, cigar_off,\n"
     "                      cigar_len, cigar_op, md_off, md_text, ev_off,"
     " threads,\n"
     "                      ev_kind, ev_base, ev_qual, ev_mdref, mismatches,"
     " r);\n"
     "  return r;\n",
     "  return guarded([&]() -> void* {\n"
     "    std::unique_ptr<Reads> r(new Reads());\n"
     "    fill_events_columns(n, start, mapq, seq_off, seq, qual, cigar_off,\n"
     "                        cigar_len, cigar_op, md_off, md_text, ev_off,"
     " threads,\n"
     "                        ev_kind, ev_base, ev_qual, ev_mdref,"
     " mismatches,\n"
     "                        r.get());\n"
     "    return r.release();\n"
     "  });\n"),
    ("guac_runtime.cpp",
     "guac_decode_sam: a refusal says why (the SAM parser's messages were "
     "dropped with the handle, :1516)",
     "  std::vector<uint8_t> raw;\n"
     "  if (!read_file(path, &raw)) return nullptr;\n"
     "  size_t size = raw.size();\n"
     "  raw.push_back(0);  // strtol guard for a truncated final line\n"
     "  Reads* r = new Reads();\n"
     "  if (!parse_sam_text(raw, size, r, threads)) {\n"
     "    delete r;\n"
     "    return nullptr;\n"
     "  }\n"
     "  return r;\n",
     "  return guarded([&]() -> void* {\n"
     "    std::vector<uint8_t> raw;\n"
     "    if (!read_file(path, &raw)) return decode_failed(\"cannot read the"
     " file\");\n"
     "    size_t size = raw.size();\n"
     "    raw.push_back(0);  // strtol guard for a truncated final line\n"
     "    std::unique_ptr<Reads> r(new Reads());\n"
     "    if (!parse_sam_text(raw, size, r.get(), threads))\n"
     "      return decode_failed(r->error);\n"
     "    return r.release();\n"
     "  });\n"),
    ("guac_pack.cpp",
     f"{_PACK}: a row with a long key sorts and classifies its alleles "
     "under long_key_mu (another block's push_back moved long_keys under "
     "the reads: a use after free, a crash on the card's host)",
     "",
     "        // Other blocks intern long keys while this one reads them: a\n"
     "        // push_back that grows long_keys moves every key, so a row with\n"
     "        // a long key reads the table under its lock.\n"
     "        std::unique_lock<std::mutex> long_lock(long_key_mu, "
     "std::defer_lock);\n"
     "        if (has_long) long_lock.lock();\n"),
    ("guac_pack.cpp", f"{_PACK}: the lock ends with the row's reads",
     "",
     "        if (has_long) long_lock.unlock();\n"),
)


def _hunks(original: str, copy: str):
    a, b = original.splitlines(True), copy.splitlines(True)
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return [
        ("".join(a[i0:i1]), "".join(b[j0:j1]))
        for tag, i0, i1, j0, j1 in matcher.get_opcodes()
        if tag != "equal"
    ]


@pytest.mark.parametrize("name", port_native.SOURCES)
def test_copy_equals_native_outside_the_listed_repairs(name):
    with open(os.path.join(ROOT, "native", name)) as fh:
        original = fh.read()
    for pattern, replacement in _REWRITE:
        original = pattern.sub(replacement, original)
    with open(os.path.join(port_native.CSRC_DIR, name)) as fh:
        copy = fh.read()
    listed = [(was, now) for f, _why, was, now in REPAIRS if f == name]
    assert _hunks(original, copy) == listed


# --- the copy under AddressSanitizer -------------------------------------

# The header bytes the decoders read: ID1 ID2 (0, 1), XLEN (10, 11), and the
# BC subfield SI1 SI2 SLEN BSIZE (12-17); of FLG (3) only FEXTRA (bit 2).
_READ_BYTES = {0, 1, *range(10, 18)}


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """The decode harness with -fsanitize=address and the pack harness with
    -fsanitize=thread, each built once with the port's copy: every g++ of
    both side by side, then the two links."""
    exes = native_build.build(tmp_path_factory.mktemp("sanitized"), {
        "address": native_build.DECODE_HARNESS,
        "thread": native_build.PACK_HARNESS})
    return {"asan": exes["address"], "tsan": exes["thread"]}


@pytest.fixture(scope="module")
def harness(harnesses):
    return harnesses["asan"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The fixture at scale 0.02, depth 0.05, seed 7. Its normal BAM
    (10,509 bytes, 250 reads) is one data block and the EOF block; its
    germline BAM (101,728 bytes, 4,306 reads) has 15 blocks, so a chunk's
    block walk crosses many headers."""
    out = str(tmp_path_factory.mktemp("small"))
    manifest = make_scale_fixture(out, scale=0.02, depth_scale=0.05, seed=7)
    assert manifest["counts"]["normal"] == 250
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _block_offsets(data: bytes):
    """Start of every BGZF block of a well-formed file."""
    starts, off = [], 0
    while off < len(data):
        (xlen,) = struct.unpack_from("<H", data, off + 10)
        assert xlen == 6 and data[off + 12:off + 14] == b"BC"
        (bsize,) = struct.unpack_from("<H", data, off + 16)
        starts.append(off)
        off += bsize + 1
    assert off == len(data)
    return starts


def _bgzf_header(xlen: int, extra: bytes) -> bytes:
    return bytes([0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF]) + struct.pack(
        "<H", xlen) + extra


def _inputs(bam_path, sam_path, n_mutants, out):
    """(path, kind) of every input made from one BAM (and its SAM):
    'clean' (well-formed), 'malformed', 'read-bytes' / 'read-bytes0' (a
    mutation of header bytes the decoders read, past the header block / in
    it), 'ignored' (a mutation of bytes they skip: CM, MTIME, XFL, OS, FLG
    outside FEXTRA), 'sam' (SAM text, whole or cut)."""
    with open(bam_path, "rb") as fh:
        bam = fh.read()
    starts = _block_offsets(bam)
    inputs = [(bam_path, "clean")]

    def write(name, data, kind):
        path = os.path.join(out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        inputs.append((path, kind))

    # A last header whose XLEN (0xFFFF) runs past the end of the file.
    write("xlen.bam", bam + _bgzf_header(0xFFFF, bytes(16)), "malformed")
    # A last header whose BC subfield's BSIZE lies past the end of the file.
    extra = b"XX" + struct.pack("<H", 8) + bytes(8) + b"BC" + struct.pack(
        "<H", 2)
    write("bsize.bam", bam + _bgzf_header(16, extra), "malformed")
    # A first block whose BSIZE (1) does not cover its own header: its
    # footer would lie before the buffer and its deflate data would have a
    # negative length.
    write("short.bam", bam[:16] + b"\0\0" + bam[18:], "read-bytes0")
    for cut in range(1, 65):
        kind = "clean" if len(bam) - cut in starts else "malformed"
        write(f"cut{cut}.bam", bam[:-cut], kind)
    rng = np.random.default_rng(2026)
    for i in range(n_mutants):
        data = bytearray(bam)
        picks = rng.choice(len(starts) * 18, size=int(rng.integers(1, 4)),
                           replace=False)
        hit = set()  # blocks with a mutated byte that the decoders read
        for pick in picks:
            block, byte = divmod(int(pick), 18)
            flip = int(rng.integers(1, 256))
            data[starts[block] + byte] ^= flip
            if byte in _READ_BYTES or (byte == 3 and flip & 4):
                hit.add(block)
        kind = ("ignored" if not hit else
                "read-bytes0" if 0 in hit else "read-bytes")
        write(f"mut{i}.bam", bytes(data), kind)
    with open(sam_path, "rb") as fh:
        sam = fh.read()
    inputs.append((sam_path, "sam"))
    for cut in range(1, 65):
        write(f"cut{cut}.sam", sam[:-cut], "sam")
    return inputs, bam


def _chunk_lists(bam_path, bam, regions):
    """Chunk lists for guac_decode_bam_chunks: the .bai chunks of each
    region, and three single chunks that start inside a block (a .bai
    whose virtual offsets do not land on a block)."""
    index = BamIndex(ensure_bam_index(bam_path))
    lists = [optimize_chunks([index.chunks_for_region(*region)])
             for region in regions]
    starts = set(_block_offsets(bam))
    inside = [c for c in (1, 3_001, len(bam) // 2 + 7) if c not in starts]
    return lists + [[(c << 16, len(bam) << 16)] for c in inside]


@pytest.mark.parametrize("sample,mutants,regions", [
    # the input of the reproduction: one data block
    ("normal", 300, ((0, 0, 5_000), (0, 5_000, 12_000), (0, 15_000, 20_000))),
    # 15 blocks, regions on both contigs
    ("germline", 200, ((0, 0, 5_000), (0, 6_000, 8_000), (1, 40_000, 70_000))),
])
def test_copy_reads_no_byte_outside_its_buffers(
        harness, small, tmp_path, sample, mutants, regions):
    bam_path = small[f"{sample}_bam"]
    inputs, bam = _inputs(bam_path, small[sample], mutants, str(tmp_path))
    lists = _chunk_lists(bam_path, bam, regions)
    chunks_file = tmp_path / "chunks.txt"
    chunks_file.write_text("".join(
        " ".join(f"{b} {e}" for b, e in chunk_list) + "\n"
        for chunk_list in lists))
    # An allocation above 64 MiB is a report too: these inputs inflate to
    # less than 2 MB, so a larger one sized itself from a corrupt ISIZE.
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=0:max_allocation_size_mb=64")
    run = subprocess.run(
        [harness, str(chunks_file), *(p for p, _ in inputs)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert "AddressSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    counts = {path: [n for n, _ in calls] for path, calls in
              native_build.parse_decodes(run.stdout).items()}
    assert len(counts) == len(inputs)
    # Per input: the whole-file decoder, the whole-file chunk, each chunk
    # list, the SAM decoder.
    clean = counts[bam_path]
    n_reads = clean[0]
    assert clean[1] == n_reads > 0 and clean[-1] == -1
    assert all(0 < n <= n_reads for n in clean[2:2 + len(regions)]), clean
    for path, kind in inputs:
        got = counts[path]
        bam_call, chunk_calls, sam_call = got[0], got[1:-1], got[-1]
        if kind == "sam":
            assert bam_call == -1 and set(chunk_calls) == {-1}, path
            assert sam_call in (-1, n_reads), (path, sam_call)
            continue
        assert sam_call == -1, path  # a BAM is no SAM text
        if kind in ("clean", "ignored"):
            assert got == clean, (path, got)
        elif kind == "read-bytes0":
            # The header block is malformed: no decoder gives a handle.
            assert bam_call == -1 and set(chunk_calls) == {-1}, (path, got)
        else:
            # Malformed past the header block: the whole-file decoder
            # refuses; a chunk decoder keeps the records of the blocks
            # before the fault, never more.
            assert bam_call == -1, (path, got)
            for n, want in zip(chunk_calls, clean[1:-1]):
                assert n == -1 or 0 <= n <= want, (path, got)
    kinds = [k for _, k in inputs]
    for kind in ("read-bytes", "read-bytes0", "ignored"):
        assert kinds.count(kind) >= 5, (kind, kinds.count(kind))


# --- the packer's threads under ThreadSanitizer ---------------------------


# The dense modes pack windows of the dense route's smallest tile (4,096
# loci; a full [L, D] tile of a whole deep contig is too large), the first
# eight of each contig; the tumor screen's mode packs the tumor BAM.
_DENSE_WINDOW = ("4096", "8")
_WHOLE = ("0", "0")


@pytest.mark.parametrize("fixture,sample,mode,window", [
    pytest.param("small", "germline_bam", 1, _WHOLE, id="small"),
    pytest.param("fx", "germline_bam", 1, _WHOLE, id="fx"),
    pytest.param("small", "germline_bam", 0, _DENSE_WINDOW, id="full"),
    pytest.param("small", "germline_bam", 2, _DENSE_WINDOW, id="likelihood"),
    pytest.param("small", "tumor_bam", 3, _DENSE_WINDOW,
                 id="likelihood_mapq"),
])
def test_copy_packs_without_a_data_race(
        harnesses, request, fixture, sample, mode, window):
    """The packer's passes run one thread per block of rows. In the CSR
    pass (mode 1) every thread interns the long keys of its insertions and
    deletions into one table; a row that reads that table while another
    block grows it read freed memory (the reference packer does, and it
    crashed the germline-standard run on the card's host). Both germline
    BAMs at scale 0.02 have such rows: the packer over each contig, twice,
    gives no ThreadSanitizer report and the same screen flags each time.
    The full tiles of the dense route (mode 0) and the dense likelihood
    tiles (mode 2, and mode 3 with the tumor's MAPQ plane) are held the
    same way, in windows, on 16 threads."""
    bam = request.getfixturevalue(fixture)[sample]
    run = subprocess.run(
        [harnesses["tsan"], bam, "2", str(mode), *window, "16"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS="halt_on_error=0"),
    )
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    rows = {}
    for line in run.stdout.splitlines():
        got_mode, contig, *numbers = line.split()
        assert int(got_mode) == mode
        rows[contig] = tuple(map(int, numbers))
    contigs = {"deep1m"} if sample == "tumor_bam" else {"deep1m", "shallow8m"}
    assert set(rows) == contigs
    assert all(n_rows > 0 and checksum > 0
               for n_rows, _, checksum, _ in rows.values()), rows
    if mode == 1:
        # One call per contig, and the screen flags rows on each.
        assert all(n_windows == 1 and n_flags > 0
                   for _, n_windows, _, n_flags in rows.values()), rows


def test_copy_builds_events_without_a_data_race(harnesses, fx):
    """guac_build_events, the event builder of reads that were not decoded
    from a BAM (SAM and object inputs), over the germline BAM's decoded
    columns on 16 threads, twice: no ThreadSanitizer report, and the event
    arrays, mismatches and specials equal the decoder's own each time."""
    run = subprocess.run(
        [harnesses["tsan"], fx["germline_bam"], "2", "events", "16"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS="halt_on_error=0"),
    )
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    word, n_reads, n_events, n_specials = run.stdout.split()
    assert word == "events" and int(n_reads) == 84_296
    assert int(n_events) > int(n_reads) and int(n_specials) > 0


# --- the copy against the JAX package's library ---------------------------


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _assert_same_columns(port, ref):
    assert port is not None and ref is not None
    assert port.n > 0
    for field in dataclasses.fields(ref):
        a, b = getattr(port, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name


def _bai_chunks(path):
    """The .bai chunks of two stretches of shallow8m: a pushdown that skips
    most of the file (deep1m fits in one 16 kbp bin of the index)."""
    index = BamIndex(ensure_bam_index(path))
    return optimize_chunks([index.chunks_for_region(1, 40_000, 70_000),
                            index.chunks_for_region(1, 100_000, 120_000)])


@pytest.mark.parametrize("mode", ["whole", "bai", "sam"])
def test_copy_decodes_what_the_jax_library_decodes(fx, mode):
    if mode == "sam":
        port = port_columnar.decode_sam_columnar(fx["germline"])
        ref = jax_columnar.decode_sam_columnar(fx["germline"])
    else:
        chunks = _bai_chunks(fx["germline_bam"]) if mode == "bai" else None
        port = port_columnar.decode_bam_columnar(fx["germline_bam"],
                                                 chunks=chunks)
        ref = jax_columnar.decode_bam_columnar(fx["germline_bam"],
                                               chunks=chunks)
        if chunks is not None:
            assert 0 < ref.n < 84_296 // 2
    _assert_same_columns(port, ref)


# --- the package alone ----------------------------------------------------

_ALONE = r"""
import json, os, sys

events = []


def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        events.append(["open", os.path.abspath(args[0])])
    elif event == "subprocess.Popen":
        events.append(["popen", [str(a) for a in args[1]]])
    elif event == "ctypes.dlopen":
        events.append(["dlopen", str(args[0])])


from guacamole_tpu_torch.runtime import columnar, native

sys.addaudithook(hook)
lib = native.load_library()
built = list(events)
cols = columnar.decode_bam_columnar(sys.argv[1])
print(json.dumps({"lib": lib and lib._name, "events": built,
                  "reads": cols.n, "package": native.__file__}))
"""


def test_package_alone_builds_its_library_and_decodes(fx, tmp_path):
    """The package copied alone, with no native/ beside it: load_library
    compiles the package's own sources into the package's _build/, and
    opens, runs and loads nothing outside the package to do so."""
    alone = tmp_path / "alone"
    pkg = alone / "guacamole_tpu_torch"
    shutil.copytree(PORT_PKG, pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(alone)
    run = subprocess.run(
        [sys.executable, "-c", _ALONE, fx["germline_bam"]],
        cwd=str(alone), env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.splitlines()[-1])
    assert got["package"].startswith(str(pkg) + os.sep)
    assert os.path.dirname(got["lib"]) == str(pkg / "_build")
    assert got["reads"] == 84_296
    inside = str(pkg) + os.sep
    compiles = [args for kind, args in got["events"] if kind == "popen"]
    assert len(compiles) == 1
    sources = [a for a in compiles[0] if a.endswith(".cpp")]
    assert sources == [str(pkg / "runtime" / "csrc" / n)
                       for n in port_native.SOURCES]
    for kind, what in got["events"]:
        if kind == "open":
            assert what.startswith(inside) or what == "/proc/cpuinfo", what
        elif kind == "dlopen":
            assert what.startswith(inside), what
