"""ctypes bindings for the native host runtime (native/guac_runtime.cpp).

The shared library performs BGZF inflation (multithreaded), BAM record
parsing, MD expansion, and pileup event-array construction; this module
exposes its buffers as zero-copy numpy views that free the native handle
when the last view is garbage-collected.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

# The port builds its own copy of the library (the JAX package's lives in
# guacamole_tpu/runtime/, written there by native/Makefile).
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_BUILD_DIR)), "native")
_NATIVE_SOURCES = ("guac_runtime.cpp", "guac_pack.cpp")
# The flags of native/Makefile.
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")
_LDFLAGS = ("-shared", "-lz", "-pthread", "-ldl")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _cpu_flags() -> bytes:
    """This host's CPU feature flags: -march=native builds for them, so a
    library built on one machine must not be loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def _library_path() -> Optional[str]:
    """_build/libguac_runtime_<hash>.so, the hash taken over the sources,
    the flags and the host's CPU features; None without the sources."""
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS).encode() + _cpu_flags())
    try:
        for name in _NATIVE_SOURCES:
            with open(os.path.join(_NATIVE_DIR, name), "rb") as fh:
                h.update(name.encode() + b"\0" + fh.read())
    except OSError:
        return None
    return os.path.join(_BUILD_DIR, f"libguac_runtime_{h.hexdigest()[:16]}.so")


def _try_build(lib_path: str) -> bool:
    """Compile native/guac_runtime.cpp and native/guac_pack.cpp, unchanged,
    into the port's _build/ directory if a toolchain is available. The
    compiler writes to a name of its own and os.replace moves it into
    place, so concurrent first users never load half a file."""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            [
                os.environ.get("CXX", "g++"), *_CXXFLAGS,
                *(os.path.join(_NATIVE_DIR, name) for name in _NATIVE_SOURCES),
                "-o", tmp, *_LDFLAGS,
            ],
            check=True,
            capture_output=True,
            timeout=300,
        )
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    lib_path = _library_path()
    if lib_path is None:
        return None
    if not os.path.exists(lib_path) and not _try_build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None

    lib.guac_decode_bam.restype = ctypes.c_void_p
    lib.guac_decode_bam.argtypes = [ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "guac_decode_sam"):
        lib.guac_decode_sam.restype = ctypes.c_void_p
        lib.guac_decode_sam.argtypes = [ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "guac_decode_bam_chunks"):
        lib.guac_decode_bam_chunks.restype = ctypes.c_void_p
        lib.guac_decode_bam_chunks.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
    lib.guac_free_reads.argtypes = [ctypes.c_void_p]
    for name in ("guac_num_reads", "guac_num_refs", "guac_num_samples",
                 "guac_num_specials"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.guac_ref_name.restype = ctypes.c_char_p
    lib.guac_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.guac_ref_length.restype = ctypes.c_int64
    lib.guac_ref_length.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.guac_sample_name.restype = ctypes.c_char_p
    lib.guac_sample_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.guac_header_text.restype = ctypes.c_char_p
    lib.guac_header_text.argtypes = [ctypes.c_void_p]
    lib.guac_specials.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6

    if hasattr(lib, "guac_build_events"):
        lib.guac_build_events.restype = ctypes.c_void_p
        lib.guac_build_events.argtypes = (
            [ctypes.c_int64]  # n
            + [ctypes.c_void_p] * 11  # input columns
            + [ctypes.c_int]  # threads
            + [ctypes.c_void_p] * 5  # ev outputs + mismatches
        )

    # tile packer (absent in older builds of the shared library)
    if not hasattr(lib, "guac_pack_tile"):
        _lib = lib
        return _lib
    lib.guac_pack_tile.restype = ctypes.c_void_p
    lib.guac_pack_tile.argtypes = (
        [ctypes.c_int64]  # n_reads
        + [ctypes.c_void_p] * 6  # read columns
        + [ctypes.c_void_p] * 5  # event arrays
        + [ctypes.c_int64]  # n_specials
        + [ctypes.c_void_p] * 7  # specials + payload
        + [ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p]  # contig, loci
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]  # K, depth_pad, l_pad
        + [ctypes.c_int64, ctypes.c_int64]  # mode, min_mapq
        + [ctypes.c_void_p, ctypes.c_int64]  # ref contig
        + [ctypes.c_int64, ctypes.c_int64]  # scan_lo, scan_hi
        + [ctypes.c_double, ctypes.c_int64]  # ll_screen_margin, kind
        + [ctypes.c_int64]  # skip_nibbles
        + [ctypes.c_double]  # ll_screen_min_phred
    )
    lib.guac_free_tile.argtypes = [ctypes.c_void_p]
    lib.guac_tile_L.restype = ctypes.c_int64
    lib.guac_tile_L.argtypes = [ctypes.c_void_p]
    lib.guac_tile_D.restype = ctypes.c_int64
    lib.guac_tile_D.argtypes = [ctypes.c_void_p]

    if hasattr(lib, "guac_normalize_ll_rows"):
        lib.guac_normalize_ll_rows.restype = None
        lib.guac_normalize_ll_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
        ]

    if hasattr(lib, "guac_counts_screen"):
        lib.guac_counts_screen.restype = None
        lib.guac_counts_screen.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]

    if hasattr(lib, "guac_covered_loci"):
        lib.guac_covered_loci.restype = ctypes.c_void_p
        lib.guac_covered_loci.argtypes = (
            [ctypes.c_int64]  # n_reads
            + [ctypes.c_void_p] * 3  # ref_id, start, end
            + [ctypes.c_int32, ctypes.c_int64]  # contig, n_ranges
            + [ctypes.c_void_p] * 2  # range_lo, range_hi
            + [ctypes.c_int64, ctypes.c_int64]  # scan_lo, scan_hi
        )
        lib.guac_free_covered.argtypes = [ctypes.c_void_p]
        lib.guac_covered_data.restype = ctypes.c_void_p
        lib.guac_covered_data.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
        ]

    _lib = lib
    return _lib


_TILE_ACCESSORS = {
    "ref_base": np.uint8,
    "depth": np.int32,
    "num_alleles": np.int16,
    "overflow": np.uint8,
    "allele_id": np.int16,
    "qual": np.int16,
    "mapq": np.int16,
    "strand": np.uint8,
    "mismatches": np.int16,
    "edge": np.int32,
    "read_index": np.int32,
    "valid": np.uint8,
    "packed_nib": np.uint8,
    "csr_nib": np.uint8,
    "csr_off": np.int32,
    "ll_pack": np.uint16,
    "ll_pack8": np.uint8,
    "ll_qvals": np.uint8,
    "ll_mapq": np.uint8,
    "is_variant": np.uint8,
    "is_standard_alt": np.uint8,
    "counts": np.int32,
    "ll_candidates": np.uint8,
    "key_blob": np.uint8,
    "key_ref_off": np.int64,
    "key_alt_off": np.int64,
    "uniq_key": np.int32,
    "uniq_off": np.int64,
}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_tile_native(
    cols,
    contig_id: int,
    loci: np.ndarray,
    max_alleles: int,
    depth_pad: int = 0,
    l_pad: int = 0,
    ref_contig: Optional[bytes] = None,
    mode: int = 0,
    min_mapq: int = 0,
    scan_window=None,
    ll_screen_margin: float = 0.0,
    ll_screen_kind: int = 1,
    skip_nibbles: bool = False,
    ll_screen_min_phred: float = 0.0,
):
    """Run the C++ tile packer over columnar reads. Returns a dict of numpy
    arrays (LocusTile fields + allele key tables), or None if unavailable."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_pack_tile"):
        return None
    loci = np.ascontiguousarray(loci, dtype=np.int64)
    arrays = {
        name: np.ascontiguousarray(getattr(cols, attr))
        for name, attr in (
            ("ref_id", "ref_id"),
            ("start", "start"),
            ("end", "end"),
            ("mapq", "mapq"),
            ("flags", "flags_"),
            ("mismatches", "mismatches"),
            ("ev_off", "ev_off"),
            ("ev_kind", "ev_kind"),
            ("ev_base", "ev_base"),
            ("ev_qual", "ev_qual"),
            ("ev_mdref", "ev_mdref"),
            ("sp_read", "sp_read"),
            ("sp_offset", "sp_offset"),
            ("sp_kind", "sp_kind"),
            ("sp_payload_offset", "sp_payload_offset"),
            ("sp_payload_len", "sp_payload_len"),
            ("sp_qual", "sp_qual"),
            ("special_payload", "special_payload"),
        )
    }
    ref_arr = (
        np.frombuffer(ref_contig, dtype=np.uint8) if ref_contig else None
    )
    handle = lib.guac_pack_tile(
        cols.n,
        _ptr(arrays["ref_id"]),
        _ptr(arrays["start"]),
        _ptr(arrays["end"]),
        _ptr(arrays["mapq"]),
        _ptr(arrays["flags"]),
        _ptr(arrays["mismatches"]),
        _ptr(arrays["ev_off"]),
        _ptr(arrays["ev_kind"]),
        _ptr(arrays["ev_base"]),
        _ptr(arrays["ev_qual"]),
        _ptr(arrays["ev_mdref"]),
        len(arrays["sp_read"]),
        _ptr(arrays["sp_read"]),
        _ptr(arrays["sp_offset"]),
        _ptr(arrays["sp_kind"]),
        _ptr(arrays["sp_payload_offset"]),
        _ptr(arrays["sp_payload_len"]),
        _ptr(arrays["sp_qual"]),
        _ptr(arrays["special_payload"]),
        contig_id,
        len(loci),
        _ptr(loci),
        max_alleles,
        depth_pad,
        l_pad,
        mode,
        min_mapq,
        _ptr(ref_arr) if ref_arr is not None else None,
        len(ref_arr) if ref_arr is not None else 0,
        scan_window[0] if scan_window is not None else 0,
        scan_window[1] if scan_window is not None else 0,
        float(ll_screen_margin),
        int(ll_screen_kind),
        1 if skip_nibbles else 0,
        float(ll_screen_min_phred),
    )
    if not handle:
        return None
    owner = _NativeOwner(lib.guac_free_tile, handle)
    out = {
        name: _fetch_array(lib, handle, f"tile_{name}", dtype, owner=owner)
        for name, dtype in _TILE_ACCESSORS.items()
        if hasattr(lib, f"guac_tile_{name}")
    }
    out["L"] = lib.guac_tile_L(handle)
    out["D"] = lib.guac_tile_D(handle)
    return out


def normalize_ll_rows_native(
    lls: np.ndarray, row_off: np.ndarray
) -> bool:
    """In-place per-row normalization of flat genotype log-likelihoods
    (the native twin of likelihood._normalization_log_total + subtract —
    bit-identical: same libm calls, same sequential order). Returns False
    when the library/entry point is unavailable (caller falls back)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_normalize_ll_rows"):
        return False
    assert lls.dtype == np.float64 and lls.flags.c_contiguous
    row_off = np.ascontiguousarray(row_off, dtype=np.int64)
    lib.guac_normalize_ll_rows(_ptr(lls), _ptr(row_off), len(row_off) - 1)
    return True


def counts_screen_native(
    counts: np.ndarray, is_variant: np.ndarray, threshold
) -> Optional[np.ndarray]:
    """[L] bool candidate mask from [L, K] counts via the native rule
    (None when the library/entry point is unavailable)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_counts_screen"):
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    iv = np.ascontiguousarray(is_variant, dtype=np.uint8)
    L, K = counts.shape
    mask = np.empty(L, dtype=np.uint8)
    lib.guac_counts_screen(
        _ptr(counts),
        _ptr(iv),
        L,
        K,
        -1 if threshold is None else int(threshold),
        _ptr(mask),
    )
    return mask.astype(bool)


def covered_loci_native(
    cols, contig_id: int, loci_ranges, scan_window=None
) -> Optional[np.ndarray]:
    """Sorted int64 loci of `loci_ranges` covered by >= 1 read, computed
    natively (None when the library/entry point is unavailable). The
    native call merges read intervals and materializes the loci array in
    one pass — the Python fallback pays seconds of arange/concatenate at
    whole-contig scale."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_covered_loci"):
        return None
    ranges = np.asarray(loci_ranges, dtype=np.int64).reshape(-1, 2)
    range_lo = np.ascontiguousarray(ranges[:, 0])
    range_hi = np.ascontiguousarray(ranges[:, 1])
    ref_id = np.ascontiguousarray(cols.ref_id)
    start = np.ascontiguousarray(cols.start)
    end = np.ascontiguousarray(cols.end)
    handle = lib.guac_covered_loci(
        cols.n,
        _ptr(ref_id),
        _ptr(start),
        _ptr(end),
        contig_id,
        len(ranges),
        _ptr(range_lo),
        _ptr(range_hi),
        scan_window[0] if scan_window is not None else 0,
        scan_window[1] if scan_window is not None else 0,
    )
    if not handle:
        return None
    owner = _NativeOwner(lib.guac_free_covered, handle)
    n = ctypes.c_int64()
    ptr = lib.guac_covered_data(handle, ctypes.byref(n))
    if not ptr or n.value == 0:
        return np.empty(0, dtype=np.int64)
    buf = _CBuffer(ptr, int(n.value) * 8, owner)
    return np.asarray(buf).view(np.int64)


_ACCESSORS = {
    "ref_id": np.int32,
    "start": np.int64,
    "end": np.int64,
    "mapq": np.int32,
    "flags": np.uint16,
    "mate_ref_id": np.int32,
    "mate_start": np.int64,
    "tlen": np.int32,
    "mismatches": np.int32,
    "sample_id": np.int32,
    "seq_off": np.int64,
    "seq": np.uint8,
    "qual": np.uint8,
    "cigar_off": np.int64,
    "cigar_len": np.uint32,
    "cigar_op": np.uint8,
    "md_off": np.int64,
    "md_text": np.uint8,
    "ev_off": np.int64,
    "ev_kind": np.uint8,
    "ev_base": np.uint8,
    "ev_qual": np.uint8,
    "ev_mdref": np.uint8,
    "special_payload": np.uint8,
}


class _NativeOwner:
    """Keeps a native handle alive while zero-copy numpy views reference
    its buffers; frees it when the last view is garbage-collected."""

    __slots__ = ("_free", "_handle")

    def __init__(self, free_fn, handle):
        self._free = free_fn
        self._handle = handle

    def __del__(self):
        try:
            self._free(self._handle)
        except Exception:
            pass


class _CBuffer:
    """numpy array-interface shim over a raw C pointer, pinning the owner
    (so views created from it keep the native allocation alive)."""

    __slots__ = ("_owner", "__array_interface__")

    def __init__(self, ptr: int, nbytes: int, owner):
        self._owner = owner
        self.__array_interface__ = {
            "data": (ptr, False),
            "shape": (nbytes,),
            "typestr": "|u1",
            "version": 3,
        }


def _fetch_array(lib, handle, name: str, dtype, owner=None) -> np.ndarray:
    """View a native buffer as a numpy array.

    With an owner, the view is zero-copy and the owner (which frees the
    handle on GC) is pinned via the array base; without one the data is
    copied so the caller may free the handle immediately.
    """
    fn = getattr(lib, f"guac_{name}")
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    n = ctypes.c_int64()
    ptr = fn(handle, ctypes.byref(n))
    if not ptr or n.value == 0:
        return np.empty(0, dtype=dtype)
    itemsize = np.dtype(dtype).itemsize
    if owner is not None:
        return np.asarray(_CBuffer(ptr, n.value * itemsize, owner)).view(dtype)
    buf = ctypes.cast(
        ptr, ctypes.POINTER(ctypes.c_char * (n.value * itemsize))
    ).contents
    return np.frombuffer(buf, dtype=dtype).copy()


def build_events_native(
    start: np.ndarray,
    mapq: np.ndarray,
    seq_off: np.ndarray,
    seq: np.ndarray,
    qual: np.ndarray,
    cigar_off: np.ndarray,
    cigar_len: np.ndarray,
    cigar_op: np.ndarray,
    md_off: np.ndarray,
    md_text: np.ndarray,
    ev_off: np.ndarray,
    threads: int = 0,
):
    """Build the per-locus event arrays for columnar reads with the native
    runtime (the same code path the BAM decoder uses) — the fast form of
    pack/events.py read_pileup_events for reads ingested from SAM / objects.

    Returns a dict with ev_kind/ev_base/ev_qual/ev_mdref (sized ev_off[-1]),
    mismatches [n], and the sp_* specials arrays, or None if the library
    (or this entry point) is unavailable."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_build_events"):
        return None
    n = len(start)
    ins = {
        "start": np.ascontiguousarray(start, dtype=np.int64),
        "mapq": np.ascontiguousarray(mapq, dtype=np.int32),
        "seq_off": np.ascontiguousarray(seq_off, dtype=np.int64),
        "seq": np.ascontiguousarray(seq, dtype=np.uint8),
        "qual": np.ascontiguousarray(qual, dtype=np.uint8),
        "cigar_off": np.ascontiguousarray(cigar_off, dtype=np.int64),
        "cigar_len": np.ascontiguousarray(cigar_len, dtype=np.uint32),
        "cigar_op": np.ascontiguousarray(cigar_op, dtype=np.uint8),
        "md_off": np.ascontiguousarray(md_off, dtype=np.int64),
        "md_text": np.ascontiguousarray(md_text, dtype=np.uint8),
        "ev_off": np.ascontiguousarray(ev_off, dtype=np.int64),
    }
    total = int(ins["ev_off"][-1]) if n else 0
    out = {
        "ev_kind": np.empty(total, dtype=np.uint8),
        "ev_base": np.empty(total, dtype=np.uint8),
        "ev_qual": np.empty(total, dtype=np.uint8),
        "ev_mdref": np.empty(total, dtype=np.uint8),
        "mismatches": np.zeros(n, dtype=np.int32),
    }
    handle = lib.guac_build_events(
        n,
        *(_ptr(ins[k]) for k in (
            "start", "mapq", "seq_off", "seq", "qual", "cigar_off",
            "cigar_len", "cigar_op", "md_off", "md_text", "ev_off",
        )),
        threads,
        _ptr(out["ev_kind"]),
        _ptr(out["ev_base"]),
        _ptr(out["ev_qual"]),
        _ptr(out["ev_mdref"]),
        _ptr(out["mismatches"]),
    )
    if not handle:
        return None
    try:
        n_specials = lib.guac_num_specials(handle)
        sp = {
            "sp_read": np.zeros(n_specials, dtype=np.int64),
            "sp_offset": np.zeros(n_specials, dtype=np.int64),
            "sp_kind": np.zeros(n_specials, dtype=np.int32),
            "sp_payload_offset": np.zeros(n_specials, dtype=np.int64),
            "sp_payload_len": np.zeros(n_specials, dtype=np.int64),
            "sp_qual": np.zeros(n_specials, dtype=np.int32),
        }
        if n_specials:
            lib.guac_specials(
                handle,
                *(_ptr(sp[k]) for k in (
                    "sp_read", "sp_offset", "sp_kind", "sp_payload_offset",
                    "sp_payload_len", "sp_qual",
                )),
            )
        out.update(sp)
        out["special_payload"] = _fetch_array(
            lib, handle, "special_payload", np.uint8
        )
    finally:
        lib.guac_free_reads(handle)
    return out


def decode_bam_native(path: str, threads: int = 0, chunks=None):
    """Decode a BAM with the native runtime. Returns a dict of numpy arrays
    + metadata, or None if the library is unavailable or decoding failed.

    chunks: optional merged (vstart, vend) BGZF virtual-offset list from a
    .bai query; only those records are decoded (region pushdown)."""
    lib = load_library()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    if chunks is not None:
        if not hasattr(lib, "guac_decode_bam_chunks"):
            return None
        vbeg = np.ascontiguousarray(
            [c[0] for c in chunks], dtype=np.int64
        )
        vend = np.ascontiguousarray(
            [c[1] for c in chunks], dtype=np.int64
        )
        handle = lib.guac_decode_bam_chunks(
            path.encode(), threads, len(chunks),
            _ptr(vbeg) if len(chunks) else None,
            _ptr(vend) if len(chunks) else None,
        )
    else:
        handle = lib.guac_decode_bam(path.encode(), threads)
    return _reads_handle_to_dict(lib, handle)


def decode_sam_native(path: str, threads: int = 0):
    """Decode a SAM text file with the native runtime into the same
    columnar dict as decode_bam_native, or None if unavailable."""
    lib = load_library()
    if lib is None or not hasattr(lib, "guac_decode_sam"):
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    handle = lib.guac_decode_sam(path.encode(), threads)
    return _reads_handle_to_dict(lib, handle)


def _reads_handle_to_dict(lib, handle):
    if not handle:
        return None
    owner = _NativeOwner(lib.guac_free_reads, handle)
    out = {
        name: _fetch_array(lib, handle, name, dtype, owner=owner)
        for name, dtype in _ACCESSORS.items()
    }
    n_refs = lib.guac_num_refs(handle)
    out["ref_names"] = [
        lib.guac_ref_name(handle, i).decode() for i in range(n_refs)
    ]
    out["ref_lengths"] = [
        lib.guac_ref_length(handle, i) for i in range(n_refs)
    ]
    out["samples"] = [
        lib.guac_sample_name(handle, i).decode()
        for i in range(lib.guac_num_samples(handle))
    ]
    out["header_text"] = lib.guac_header_text(handle).decode(
        errors="replace"
    )
    n_specials = lib.guac_num_specials(handle)
    sp_read = np.zeros(n_specials, dtype=np.int64)
    sp_off = np.zeros(n_specials, dtype=np.int64)
    sp_kind = np.zeros(n_specials, dtype=np.int32)
    sp_poff = np.zeros(n_specials, dtype=np.int64)
    sp_plen = np.zeros(n_specials, dtype=np.int64)
    sp_qual = np.zeros(n_specials, dtype=np.int32)
    if n_specials:
        lib.guac_specials(
            handle,
            sp_read.ctypes.data_as(ctypes.c_void_p),
            sp_off.ctypes.data_as(ctypes.c_void_p),
            sp_kind.ctypes.data_as(ctypes.c_void_p),
            sp_poff.ctypes.data_as(ctypes.c_void_p),
            sp_plen.ctypes.data_as(ctypes.c_void_p),
            sp_qual.ctypes.data_as(ctypes.c_void_p),
        )
    out["sp_read"] = sp_read
    out["sp_offset"] = sp_off
    out["sp_kind"] = sp_kind
    out["sp_payload_offset"] = sp_poff
    out["sp_payload_len"] = sp_plen
    out["sp_qual"] = sp_qual
    return out
