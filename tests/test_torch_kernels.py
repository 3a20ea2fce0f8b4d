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
from guacamole_tpu_torch.ops import cuda_kernels, edge_shapes
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


CSR_EDGE_NAMES = [case[0] for case in edge_shapes.csr_edge_cases()]


@pytest.mark.parametrize("name", CSR_EDGE_NAMES)
def test_edge_shapes_bit_equal_to_jax(name):
    """The tiles chip_smoke.py gives the counting kernel at the edges of its
    routes (ops/edge_shapes.py), through the wrapper on the CPU, unpadded
    and as a slice that starts at an odd byte of a larger tensor."""
    K = 8
    (blob, row_off, is_variant), = [
        case[1:] for case in edge_shapes.csr_edge_cases(K) if case[0] == name
    ]
    assert row_off[-1] == len(blob) or name.endswith("padded blob")
    words = t(port.pack_variant_words16(is_variant))
    sliced = torch.cat([torch.zeros(3, dtype=torch.uint8), t(blob)])[3:]
    assert sliced.data_ptr() % 2 == 1 or len(blob) == 0
    for threshold_percent in (None, 25):
        want = jax_kernels.tile_stats_csr(
            blob, row_off, is_variant, K, threshold_percent=threshold_percent
        )
        for tensor in (t(blob), sliced):
            counts, candidates = cuda_kernels.csr_count_screen(
                tensor, t(row_off), words, K, threshold_percent
            )
            assert counts.dtype == torch.int16
            np.testing.assert_array_equal(
                counts.numpy(), np.asarray(want.counts)
            )
            np.testing.assert_array_equal(
                candidates.numpy(), np.asarray(want.candidates)
            )


@pytest.mark.parametrize("reads", [254, 255, 256, 32767, 32768])
def test_counting_arithmetic_model_at_counter_edges(reads):
    """The kernel counts 16 bytes at once with a bit transpose and one
    popcount per allele into int32 counters (no packed fields, nothing to
    flush). A numpy model of that arithmetic against a plain count, for a
    row of `reads` reads of one allele: 8 and 16 bits are where a packed or
    narrowed counter would wrap, and int16 does wrap at 32768, as JAX's
    astype does."""
    K = 8
    nibbles = np.full(reads + reads % 2, 5, np.uint8)
    if reads % 2:
        nibbles[-1] = 0xF
    row = nibbles[0::2] | (nibbles[1::2] << 4)
    blob = np.concatenate([[0x21, 0x43, 0x05], row, [0x55, 0x50]]).astype(
        np.uint8
    )
    row_off = np.array([0, 3, 3 + len(row), len(blob)], np.int32)
    is_variant = np.zeros((3, K), bool)
    want = jax_kernels.tile_stats_csr(blob, row_off, is_variant, K)
    plain, _ = port.tile_stats_csr(t(blob), t(row_off), t(is_variant), K)
    model = np.stack([
        edge_shapes.count_row_model(blob, row_off[r], row_off[r + 1], K)
        for r in range(3)
    ])
    np.testing.assert_array_equal(model, np.asarray(want.counts))
    np.testing.assert_array_equal(model, plain.numpy())
    wrapped = (reads + 2**15) % 2**16 - 2**15
    assert model[1].tolist() == [0, 0, 0, 0, 0, wrapped, 0, 0]
    assert model[0].tolist() == [1, 1, 1, 1, 1, 1, 0, 0]
    assert model[2].tolist() == [1, 0, 0, 0, 0, 3, 0, 0]


@pytest.mark.parametrize("K", [1, 8, 15])
def test_counting_arithmetic_model_on_edge_rows(K):
    """The same model on rows of every edge length, at every alignment the
    tile gives them, with neighbours that would count if a mask leaked."""
    rng = np.random.default_rng(K)
    lengths = [n for n in edge_shapes.CSR_EDGE_ROW_BYTES if n < 3000]
    blob, row_off, is_variant = edge_shapes.csr_tile(
        rng, lengths + lengths[::-1], K
    )
    plain, _ = port.tile_stats_csr(t(blob), t(row_off), t(is_variant), K)
    for neighbours in (0x00, 0x11 * (K - 1)):
        model = np.stack([
            edge_shapes.count_row_model(
                blob, row_off[r], row_off[r + 1], K, neighbours)
            for r in range(len(row_off) - 1)
        ])
        np.testing.assert_array_equal(model, plain.numpy())


def test_wrapper_refuses_a_blob_beyond_int32_offsets():
    """The kernel addresses the blob in int32 with room for 16 bytes of
    alignment. (torch.empty does not touch the 2 GiB it reserves.)"""
    blob = torch.empty(cuda_kernels.MAX_BLOB_BYTES + 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_kernels.csr_count_screen(
            blob, torch.zeros(2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.uint16), 8,
        )
    assert cuda_kernels.MAX_BLOB_BYTES + 17 == 2**31


def test_launch_shapes_are_recorded_with_launches_only():
    """LAUNCH_SHAPES holds one entry per kernel launch: none on the CPU,
    and reset_launches() empties it."""
    packed, row_off, is_variant = random_csr(4)
    wire = wire_from_numpy(packed, row_off, is_variant, CPU)
    cuda_kernels.LAUNCH_SHAPES["csr_count_screen"].append((1, 2))
    cuda_kernels.csr_count_screen(
        wire.blob, wire.row_off, wire.variant_words, 8
    )
    assert list(cuda_kernels.LAUNCH_SHAPES["csr_count_screen"]) == [(1, 2)]
    cuda_kernels.reset_launches()
    assert all(not v for v in cuda_kernels.LAUNCH_SHAPES.values())
    assert set(cuda_kernels.LAUNCH_SHAPES) == set(cuda_kernels.LAUNCHES)


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
