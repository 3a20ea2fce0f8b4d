"""The compaction at the edges of its CUDA kernel's routes
(guacamole_tpu_torch/ops/edge_shapes.py::compact_edge_cases).

chip_smoke.py gives the same cases to csr_compact on the card and holds it
to the plain version. Here, on the CPU, the same numpy inputs go through
the wrapper (which runs the plain version on a CPU tensor), and
compact_candidates is held to a numpy model of the kernel's two-pass
partition (block totals, offsets, ranks tile by tile, the shared fill),
with the flags and the counts as views that start 0, 1, 3 and 15 bytes or
rows into larger tensors, and to JAX's tile_stats_csr_compact on CSR tiles
that give the same flags and counts. Every output is an integer: the
tolerance is 0.
"""

import os
import re

import numpy as np
import pytest
import torch

from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu_torch.ops import cuda_kernels, edge_shapes
from guacamole_tpu_torch.ops import kernels as port

COMPACT_NAMES = [case[0] for case in edge_shapes.compact_edge_cases(1)]
# The CSR screen of the JAX package is compiled per shape: the cases that go
# through it stay under this many rows.
JAX_COMPACT_ROWS = 50_000


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def compact_case(name, K):
    (case,) = [c for c in edge_shapes.compact_edge_cases(K, max_count=3)
               if c[0] == name]
    return case[1], case[2]


@pytest.mark.parametrize("name", COMPACT_NAMES)
def test_compaction_edges_match_the_two_pass_model(name):
    flags, counts = compact_case(name, 8)
    big = len(flags) > 1 << 20
    total = int(flags.sum())
    before = dict(cuda_kernels.LAUNCHES)
    for lead in (0, 15) if big else edge_shapes.COMPACT_LEADS:
        f = edge_shapes.view_into_larger(t(flags), lead, True)
        c = edge_shapes.view_into_larger(t(counts), lead, 77)
        for cap in edge_shapes.compact_caps(total):
            got = cuda_kernels.csr_compact(f, c, cap).numpy()
            want = port.compact_candidates(t(flags), t(counts), cap).numpy()
            np.testing.assert_array_equal(got, want)
            model = edge_shapes.compact_partition_model(
                flags, counts, cap, lead)
            np.testing.assert_array_equal(model, want)
            assert got[cap, 0] == total
            n = min(total, cap)
            assert (np.diff(got[:n, 0]) > 0).all()
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize(
    "name",
    [n for n, f, _c in edge_shapes.compact_edge_cases(1)
     if 0 < len(f) <= JAX_COMPACT_ROWS],  # the JAX screen takes no empty tile
)
def test_compaction_edges_bit_equal_to_jax(name):
    K = 2
    flags, counts = compact_case(name, K)
    blob, row_off, is_variant = edge_shapes.csr_of_counts(flags, counts)
    if len(blob) == 0:  # the JAX screen takes no empty blob: one pad byte
        blob = np.full(1, 0xFF, np.uint8)
    total = int(flags.sum())
    for cap in sorted({max(total - 1, 0), total + 8}):
        want = np.asarray(jax_kernels.tile_stats_csr_compact(
            blob, row_off, is_variant, K, cap=cap))
        got = port.compact_candidates(t(flags), t(counts), cap).numpy()
        np.testing.assert_array_equal(got, want)
        # And the screen's own flags and counts are the case's.
        np.testing.assert_array_equal(
            port.tile_stats_csr_compact(
                t(blob), t(row_off), t(is_variant), K, None, cap).numpy(),
            want)


def test_compact_wrapper_scratch_matches_the_kernel():
    assert cuda_kernels.COMPACT_MAX_BLOCKS == edge_shapes.COMPACT_MAX_BLOCKS
    # The longest input still takes at most that many blocks.
    L = 2**31 - 1 + 15
    tiles = -(-L // edge_shapes.COMPACT_TILE_FLAGS)
    chunk = -(-tiles // edge_shapes.COMPACT_MAX_BLOCKS) * (
        edge_shapes.COMPACT_TILE_FLAGS)
    assert -(-L // chunk) <= edge_shapes.COMPACT_MAX_BLOCKS


def source_constants(name):
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "guacamole_tpu_torch", "ops", "csrc", name)
    with open(path) as fh:
        return {m[1]: int(m[2]) for m in re.finditer(
            r"constexpr int (k\w+) = (\d+);", fh.read())}


def test_the_model_has_the_kernels_constants():
    """The numpy model and the edge cases follow the constants of
    csr_screen.cu: a kernel retuned without them would be checked at the
    wrong edges."""
    k = source_constants("csr_screen.cu")
    assert edge_shapes.COMPACT_FLAGS_PER_THREAD == k["kFlagsPerThread"]
    assert edge_shapes.COMPACT_TILE_FLAGS == (
        k["kCompactThreads"] * k["kFlagsPerThread"])
    assert edge_shapes.COMPACT_ONE_BLOCK_TILE_FLAGS == (
        k["kOneBlockThreads"] * k["kFlagsPerThread"])
    assert edge_shapes.COMPACT_ONE_BLOCK_FLAGS == k["kOneBlockFlags"]
    assert edge_shapes.COMPACT_MAX_BLOCKS == k["kCompactMaxBlocks"]
    assert cuda_kernels.COMPACT_MAX_BLOCKS == k["kCompactMaxBlocks"]
