"""The fused dense kernel at the edges of its CUDA kernel's routes
(guacamole_tpu_torch/ops/edge_shapes.py::dense_edge_cases).

chip_smoke.py gives the same cases to stats_ll on the card and holds it to
the plain version. Here, on the CPU, the same numpy tiles go through the
wrapper (which runs the plain version, stats_ll_math, on a CPU tensor) and
through the JAX package's fused kernel: the Pallas kernel in interpret
mode up to 8 alleles, the XLA forms beyond. Integers and flags: tolerance
0. Likelihoods: rtol 2e-5 and atol 2e-5 x max(1, D / 16), the tolerance
chip_smoke.py holds the CUDA kernel to: the JAX tests' own 2e-5 for sums
of up to 16 logs, growing with the depth because every term added may
round the running f32 sum.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu.ops.pallas_kernels import fused_tile_stats_ll
from guacamole_tpu_torch.ops import cuda_kernels, edge_shapes

DENSE_NAMES = [case[0] for case in edge_shapes.dense_edge_cases()]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def dense_case(name):
    (case,) = [c for c in edge_shapes.dense_edge_cases() if c[0] == name]
    return case[1], case[2]


def jax_stats_ll(tile, K, include_alignment, threshold_percent):
    """The JAX package's answer: the fused Pallas kernel, interpreted, where
    its unrolled pairs stay small; the XLA forms beyond 8 alleles."""
    aid, qual, mapq, strand, valid, is_variant = tile
    if K <= 8:
        out = fused_tile_stats_ll(
            *(jnp.asarray(a) for a in tile), K,
            include_alignment=include_alignment,
            threshold_percent=threshold_percent, interpret=True)
        return (out.counts, out.forward_counts, out.depth, out.candidates,
                out.log_likelihoods)
    stats = jax_kernels.tile_stats(
        aid, strand, valid, is_variant, K,
        threshold_percent=threshold_percent)
    pc = jax_kernels.probability_correct(
        qual, mapq, valid, include_alignment=include_alignment)
    ll = jax_kernels.genotype_log_likelihoods(aid, pc, valid, K)
    return (stats.counts, stats.forward_counts, stats.depth,
            stats.variant_evidence, ll)


def assert_dense_equal(got, want, D):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        got.log_likelihoods.numpy(), np.asarray(want[4]),
        rtol=2e-5, atol=2e-5 * max(1.0, D / 16))


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_dense_edges_match_jax(name):
    K, tile = dense_case(name)
    D = tile[0].shape[1]
    # Invalid slots hold values that would count: the JAX forms take the
    # tile as it is, so both must mask them.
    align, thr = (True, 8) if len(name) % 2 else (False, None)
    want = jax_stats_ll(tile, K, align, thr)
    tensors = [t(a) for a in tile]
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.stats_ll(*tensors, K, include_alignment=align,
                                threshold_percent=thr)
    assert_dense_equal(got, want, D)
    # Without likelihoods quals and MAPQs are not read.
    counts_only = cuda_kernels.stats_ll(
        tensors[0], None, None, *tensors[3:], K, threshold_percent=thr,
        with_likelihoods=False)
    assert counts_only.log_likelihoods is None
    for g, w in zip(counts_only[:4], got[:4]):
        assert torch.equal(g, w)
    # The planes as views that start 1 and 3 elements into larger tensors
    # (no 16-byte alignment), and as row slices.
    for lead in (1, 3):
        views = [
            edge_shapes.view_into_larger(x.reshape(-1), lead, 1).view(x.shape)
            for x in tensors
        ]
        assert views[0].data_ptr() % 16 != tensors[0].data_ptr() % 16
        again = cuda_kernels.stats_ll(*views, K, include_alignment=align,
                                      threshold_percent=thr)
        for g, w in zip(again, got):
            assert torch.equal(g, w)
    sliced = cuda_kernels.stats_ll(*(x[1:] for x in tensors), K,
                                   include_alignment=align,
                                   threshold_percent=thr)
    for g, w in zip(sliced, got):
        assert torch.equal(g, w[1:])
    assert cuda_kernels.LAUNCHES == before


def test_dense_edge_cases_cover_the_routes():
    depths = {c[2][0].shape[1] for c in edge_shapes.dense_edge_cases()}
    alleles = {c[1] for c in edge_shapes.dense_edge_cases()}
    lane, group = edge_shapes.DENSE_LANE_ELEMENTS, edge_shapes.DENSE_GROUP
    assert {2 * lane - 1, 2 * lane, 2 * lane + 1, 8 * lane, 32 * lane,
            group - 1, group, group + 1} <= depths
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "guacamole_tpu_torch", "ops", "csrc", "stats_ll.cu")
    with open(path) as fh:
        k = {m[1]: int(m[2]) for m in re.finditer(
            r"constexpr int (k\w+) = (\d+);", fh.read())}
    assert (lane, group) == (k["kLaneElements"], k["kGroup"])
    assert edge_shapes.DENSE_SMALL_TILE_WARPS == k["kSmallTileWarps"]
    rows = {(c[2][0].shape[0], c[2][0].shape[1])
            for c in edge_shapes.dense_edge_cases()}
    small = edge_shapes.DENSE_SMALL_TILE_THREADS
    for D, teams in edge_shapes.DENSE_SMALL_TILE_TEAMS:
        assert {(small // n + i, D) for n in teams for i in (0, 1)} <= rows
    assert set(edge_shapes.DENSE_EDGE_ALLELES) <= alleles
    assert {1, 2, 8, 15, 16, 17, 20} <= alleles
    empty = [c for c in edge_shapes.dense_edge_cases()
             if c[0].startswith("empty")]
    assert empty and all(not c[2][4].any() for c in empty)
