"""The port's counting-screen math against the JAX package, bit for bit.

Every output is an integer, so the tolerance is 0. Inputs are made with
numpy from a seed and handed to both packages. On the CPU the CUDA
wrappers take their plain twins; the kernels themselves are held against
those twins on the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from guacamole_tpu.ops import dispatch as jax_dispatch
from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu.ops.pallas_kernels import pallas_csr_screen
from guacamole_tpu_torch.ops import cuda_kernels
from guacamole_tpu_torch.ops import kernels as port
from guacamole_tpu_torch.ops.dispatch import wire_from_numpy

CPU = torch.device("cpu")


def csr_encode(aid, valid, depth):
    """Reference CSR nibble encoding (tests/test_pallas_kernels.py): row r's
    slots [0, depth[r]) as 4-bit ids (0xF where invalid), byte-aligned."""
    blobs, off = [], [0]
    for r in range(aid.shape[0]):
        nibs = [
            (int(aid[r, s]) & 0xF) if valid[r, s] else 0xF
            for s in range(int(depth[r]))
        ]
        if len(nibs) % 2:
            nibs.append(0xF)
        blobs.extend(
            nibs[i] | (nibs[i + 1] << 4) for i in range(0, len(nibs), 2)
        )
        off.append(len(blobs))
    return np.asarray(blobs, dtype=np.uint8), np.asarray(off, dtype=np.int32)


def random_csr(seed, L=64, D=17, K=8, punch=0.1):
    """A random CSR tile: depth 0..D, ids 0..K-1, a few invalid (0xF)
    slots mid-row, random variant flags. The blob pads with 0xFF to a
    fixed 1024 bytes, so seeds share the JAX forms' compiled shapes."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    slots = np.arange(D)[None, :] < depth[:, None]
    valid = slots & ~(rng.rand(L, D) < punch)
    aid = rng.randint(0, K, size=(L, D))
    is_variant = rng.rand(L, K) < 0.4
    packed, row_off = csr_encode(aid, valid, depth)
    packed = np.concatenate(
        [packed, np.full(1024 - len(packed), 0xFF, np.uint8)]
    )
    return packed, row_off, is_variant


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("threshold_percent", [None, 0, 8, 25, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_counts_candidates_bit_equal(seed, threshold_percent):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 40, size=(256, 8)).astype(np.int32)
    counts[rng.rand(256, 8) < 0.5] = 0
    depth = counts.sum(axis=1).astype(np.int32)
    is_variant = rng.rand(256, 8) < 0.5
    want = np.asarray(
        jax_kernels.counts_candidates(
            counts, depth, is_variant, threshold_percent
        )
    )
    got = port.counts_candidates(
        t(counts), t(depth), t(is_variant), threshold_percent
    ).numpy()
    np.testing.assert_array_equal(got, want)
    # The numpy host twin in the dispatch applies the same rule.
    from guacamole_tpu_torch.ops.dispatch import host_counts_candidates

    np.testing.assert_array_equal(
        host_counts_candidates(counts, is_variant, threshold_percent), want
    )


@pytest.mark.parametrize("threshold_percent", [None, 8, 50])
@pytest.mark.parametrize("K", [2, 8, 15])
def test_csr_screen_math_bit_equal(K, threshold_percent):
    packed, row_off, is_variant = random_csr(K, K=K)
    want_c, want_f = jax_kernels.csr_screen_math(
        packed, row_off, is_variant, K, threshold_percent
    )
    got_c, got_f = port.csr_screen_math(
        t(packed), t(row_off), t(is_variant), K, threshold_percent
    )
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("threshold_percent", [None, 8, 25, 50])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_stats_csr_bit_equal_to_xla_and_pallas(seed, threshold_percent):
    K = 8
    packed, row_off, is_variant = random_csr(seed, K=K)
    xla = jax_kernels.tile_stats_csr(
        packed, row_off, is_variant, K, threshold_percent=threshold_percent
    )
    pallas = pallas_csr_screen(
        packed, row_off, is_variant, K,
        threshold_percent=threshold_percent, interpret=True,
    )
    counts, candidates = port.tile_stats_csr(
        t(packed), t(row_off), t(is_variant), K, threshold_percent
    )
    assert counts.dtype == torch.int16
    for ref in (xla, pallas):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref.counts))
        np.testing.assert_array_equal(
            candidates.numpy(), np.asarray(ref.candidates)
        )
    # The kernel wrapper on CPU tensors, through the wire form, agrees too.
    wire = wire_from_numpy(packed, row_off, is_variant, CPU)
    w_counts, w_cand = cuda_kernels.csr_count_screen(
        wire.blob, wire.row_off, wire.variant_words, K, threshold_percent
    )
    np.testing.assert_array_equal(w_counts.numpy(), np.asarray(xla.counts))
    np.testing.assert_array_equal(w_cand.numpy(), np.asarray(xla.candidates))


def test_rows_spanning_pallas_blocks():
    """One row deep enough to straddle several 64-byte Pallas blocks (the
    TPU kernel's carry across sequential grid steps): the port counts the
    row's byte range directly and must agree."""
    K = 8
    rng = np.random.RandomState(11)
    L, D = 16, 400
    depth = rng.randint(0, 12, size=L)
    depth[5] = 397
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = rng.randint(0, K, size=(L, D))
    is_variant = rng.rand(L, K) < 0.4
    packed, row_off = csr_encode(aid, valid, depth)
    pallas = pallas_csr_screen(
        packed, row_off, is_variant, K, interpret=True, block_b=64
    )
    counts, candidates = port.tile_stats_csr(
        t(packed), t(row_off), t(is_variant), K
    )
    np.testing.assert_array_equal(counts.numpy(), np.asarray(pallas.counts))
    np.testing.assert_array_equal(
        candidates.numpy(), np.asarray(pallas.candidates)
    )


@pytest.mark.parametrize("threshold_percent", [None, 8])
@pytest.mark.parametrize("cap", [4, 64])
def test_tile_stats_csr_compact_bit_equal(cap, threshold_percent):
    K = 8
    packed, row_off, is_variant = random_csr(3, K=K, punch=0.0)
    want = np.asarray(
        jax_kernels.tile_stats_csr_compact(
            packed, row_off, is_variant, K,
            threshold_percent=threshold_percent, cap=cap,
        )
    )
    got = port.tile_stats_csr_compact(
        t(packed), t(row_off), t(is_variant), K, threshold_percent, cap
    ).numpy()
    np.testing.assert_array_equal(got, want)
    total = int(got[cap, 0])
    n = min(total, cap)
    assert (got[n:cap, 0] == -1).all() and (got[n:cap, 1:] == 0).all()
    assert (got[cap, 1:] == 0).all()
    # The compaction wrapper on the int16 screen output gives the same.
    counts, candidates = port.tile_stats_csr(
        t(packed), t(row_off), t(is_variant), K, threshold_percent
    )
    np.testing.assert_array_equal(
        cuda_kernels.csr_compact(candidates, counts, cap).numpy(), want
    )


def test_unpack_csr_meta_bit_equal():
    rng = np.random.RandomState(5)
    nb = rng.randint(0, 0x10000, size=300).astype(np.uint16)
    is_variant = rng.rand(300, 15) < 0.5
    words = port.pack_variant_words16(is_variant)
    np.testing.assert_array_equal(
        words, jax_dispatch.pack_variant_words16(is_variant)
    )
    want_off, want_iv = jax_dispatch._unpack_csr_meta(nb, words, 15)
    got_off = port.row_offsets(t(nb))
    assert got_off.dtype == torch.int32
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(
        port.unpack_variant_words(t(words), 15).numpy(), np.asarray(want_iv)
    )
    (want_iv2,) = jax_dispatch._unpack_variant_words(words, 8)
    np.testing.assert_array_equal(
        port.unpack_variant_words(t(words), 8).numpy(), np.asarray(want_iv2)
    )


def test_int32_offset_wire_form_for_rows_over_64kb():
    """A row beyond 64 KB of nibbles cannot ride the uint16 byte counts:
    the wire form ships int32 offsets, and the screen still matches."""
    K = 8
    rng = np.random.RandomState(2)
    depth = np.array([5, 140_001, 0, 9])
    row_off = np.concatenate([[0], np.cumsum((depth + 1) // 2)]).astype(
        np.int32
    )
    packed = (rng.randint(0, 4, size=int(row_off[-1])) * 0x11).astype(np.uint8)
    is_variant = rng.rand(4, K) < 0.5
    wire = wire_from_numpy(packed, row_off, is_variant, CPU)
    np.testing.assert_array_equal(wire.row_off.numpy(), row_off)
    counts, candidates = cuda_kernels.csr_count_screen(
        wire.blob, wire.row_off, wire.variant_words, K
    )
    want = jax_kernels.tile_stats_csr(packed, row_off, is_variant, K)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(
        candidates.numpy(), np.asarray(want.candidates)
    )


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    K = 8
    packed, row_off, is_variant = random_csr(4, K=K)
    before = dict(cuda_kernels.LAUNCHES)
    wire = wire_from_numpy(packed, row_off, is_variant, CPU)
    counts, candidates = cuda_kernels.csr_count_screen(
        wire.blob, wire.row_off, wire.variant_words, K, 8
    )
    raw = cuda_kernels.csr_compact(candidates, counts, 16)
    assert cuda_kernels.LAUNCHES == before
    p_counts, p_cand = port.csr_count_screen(
        wire.blob, wire.row_off, wire.variant_words, K, 8
    )
    assert torch.equal(counts, p_counts) and torch.equal(candidates, p_cand)
    assert torch.equal(raw, port.compact_candidates(p_cand, p_counts, 16))


def test_wrappers_reject_what_the_kernels_do_not_take():
    K = 8
    packed, row_off, is_variant = random_csr(6, K=K)
    wire = wire_from_numpy(packed, row_off, is_variant, CPU)
    with pytest.raises(ValueError):
        cuda_kernels.csr_count_screen(
            wire.blob.to(torch.int32), wire.row_off, wire.variant_words, K
        )
    with pytest.raises(ValueError):
        cuda_kernels.csr_count_screen(
            wire.blob, wire.row_off[:-1], wire.variant_words, K
        )
    with pytest.raises(ValueError):
        cuda_kernels.csr_count_screen(
            wire.blob, wire.row_off, wire.variant_words, 16
        )
    with pytest.raises(ValueError):
        cuda_kernels.csr_count_screen(
            wire.blob.to("meta"), wire.row_off.to("meta"),
            wire.variant_words.to("meta"), K,
        )
    counts = torch.zeros((10, K), dtype=torch.int16)
    with pytest.raises(ValueError):
        cuda_kernels.csr_compact(torch.zeros(9, dtype=torch.bool), counts, 4)
    with pytest.raises(ValueError):
        cuda_kernels.csr_compact(
            torch.zeros(10, dtype=torch.bool), counts.t(), 4
        )


def test_importing_the_kernels_needs_no_nvcc(tmp_path):
    """The modules import (as the CPU tests do) on a host with no nvcc; only
    a build raises, and it says why."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import guacamole_tpu_torch.ops.cuda_kernels\n"
        "from guacamole_tpu_torch.ops import build\n"
        "try:\n"
        "    build.build()\n"
        "except RuntimeError as exc:\n"
        "    assert 'nvcc not found' in str(exc), exc\n"
        "else:\n"
        "    raise SystemExit('build without nvcc did not raise')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=root,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
