"""The dense-tile functions of the port against their JAX originals.

The same numpy tile, made from a seed, goes through the JAX function and
its counterpart in guacamole_tpu_torch/ops/kernels.py: stats_ll_math (the
plain version of the stats_ll CUDA kernel, which is what the wrapper runs
on a CPU tensor) against the fused Pallas kernel in interpret mode, and
allele_counts, probability_correct, genotype_log_likelihoods, tile_stats
and tile_stats_nibble against the XLA forms. Integers and flags must be
equal; likelihoods agree to rtol = atol = 2e-5, the tolerance the JAX
package's own tests hold between its Pallas and XLA forms (f32 sums of up
to 16 logs, taken in another order). The forward step of
guacamole_tpu_torch.entry is held to __graft_entry__.entry() on its
example tile.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu.ops.dispatch import pack_nibbles
from guacamole_tpu.ops.pallas_kernels import fused_tile_stats_ll
from guacamole_tpu.ops.pallas_kernels import tile_stats_ll as jax_tile_stats_ll
from guacamole_tpu_torch.ops import cuda_kernels
from guacamole_tpu_torch.ops import kernels as port_kernels
from guacamole_tpu_torch.ops.dispatch import dense_wire_from_numpy

CPU = torch.device("cpu")
LL_TOL = dict(rtol=2e-5, atol=2e-5)


def random_tile(L=64, D=16, K=8, seed=0):
    """The tile of tests/test_pallas_kernels.py::random_tile."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    allele_id = np.where(
        valid, rng.randint(0, K, size=(L, D)), -1
    ).astype(np.int16)
    qual = np.where(valid, rng.randint(2, 45, size=(L, D)), 0).astype(np.int16)
    mapq = np.where(valid, rng.randint(0, 70, size=(L, D)), 0).astype(np.int16)
    strand = valid & (rng.rand(L, D) < 0.5)
    is_variant = rng.rand(L, K) < 0.4
    return allele_id, qual, mapq, strand, valid, is_variant


def on_cpu(tile):
    """The port's tensors of a numpy tile, through the dispatch's staging."""
    return dense_wire_from_numpy(*tile, device=CPU)[:6]


def assert_stats_equal(got, want, with_ll=True):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(
        got.forward_counts.numpy(), np.asarray(want.forward_counts))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(
        got.candidates.numpy(), np.asarray(want.candidates))
    assert got.counts.dtype == got.forward_counts.dtype == torch.int32
    assert got.depth.dtype == torch.int32 and got.candidates.dtype == torch.bool
    if with_ll:
        assert got.log_likelihoods.dtype == torch.float32
        np.testing.assert_allclose(
            got.log_likelihoods.numpy(), np.asarray(want.log_likelihoods),
            **LL_TOL)


@pytest.mark.parametrize("include_alignment", [False, True])
@pytest.mark.parametrize("K, D", [(8, 16), (4, 15), (8, 15), (4, 16)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_ll_math_matches_the_interpreted_pallas_kernel(
    seed, K, D, include_alignment
):
    tile = random_tile(D=D, K=K, seed=seed)
    want = jax_tile_stats_ll(*tile, K, include_alignment=include_alignment)
    got = port_kernels.stats_ll_math(
        *on_cpu(tile), K, include_alignment=include_alignment)
    assert_stats_equal(got, want)
    # The wrapper and the dispatching function run the same plain version on
    # a CPU tensor, and count no launch.
    before = dict(cuda_kernels.LAUNCHES)
    for fn in (cuda_kernels.stats_ll, port_kernels.tile_stats_ll):
        again = fn(*on_cpu(tile), K, include_alignment=include_alignment)
        for a, b in zip(again, got):
            assert torch.equal(a, b)
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("threshold_percent", [None, 0, 8, 50])
@pytest.mark.parametrize("include_alignment", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_ll_math_matches_fused_kernel_with_threshold(
    seed, include_alignment, threshold_percent
):
    K = 8
    tile = random_tile(D=16 - seed % 2, K=K, seed=seed)
    want = fused_tile_stats_ll(
        *(jnp.asarray(a) for a in tile), K,
        include_alignment=include_alignment,
        threshold_percent=threshold_percent, interpret=True,
    )
    got = port_kernels.stats_ll_math(
        *on_cpu(tile), K, include_alignment=include_alignment,
        threshold_percent=threshold_percent,
    )
    assert_stats_equal(got, want)
    counts_only = port_kernels.tile_stats_ll(
        on_cpu(tile)[0], None, None, *on_cpu(tile)[3:], K,
        threshold_percent=threshold_percent, with_likelihoods=False,
    )
    assert counts_only.log_likelihoods is None
    assert_stats_equal(counts_only, want, with_ll=False)


def test_stats_ll_math_uneven_rows():
    K = 4
    tile = random_tile(L=48, D=8, K=K, seed=3)
    assert_stats_equal(
        port_kernels.stats_ll_math(*on_cpu(tile), K),
        jax_tile_stats_ll(*tile, K),
    )


def test_stats_ll_math_empty_loci():
    K = 8
    tile = (
        np.full((16, 8), -1, np.int16), np.zeros((16, 8), np.int16),
        np.zeros((16, 8), np.int16), np.zeros((16, 8), bool),
        np.zeros((16, 8), bool), np.zeros((16, K), bool),
    )
    got = port_kernels.stats_ll_math(*on_cpu(tile), K)
    assert_stats_equal(got, jax_tile_stats_ll(*tile, K))
    assert not got.depth.any() and not got.candidates.any()
    assert (got.log_likelihoods == 0).all()
    assert port_kernels.stats_ll_math(
        *(t[:0] for t in on_cpu(tile)), K
    ).log_likelihoods.shape == (0, 36)


def test_stats_ll_quality_zero_gives_equal_infinities():
    """q = 0 makes pc = 0 and log 0 = -inf for the matching homozygous
    pair, in both packages."""
    K = 4
    tile = list(random_tile(L=32, D=8, K=K, seed=5))
    tile[1] = np.where(tile[4] & (tile[0] == 1), 0, tile[1]).astype(np.int16)
    want = jax_tile_stats_ll(*tile, K)
    got = port_kernels.stats_ll_math(*on_cpu(tile), K)
    want_ll = np.asarray(want.log_likelihoods)
    assert np.isneginf(want_ll).any()
    np.testing.assert_array_equal(
        np.isneginf(got.log_likelihoods.numpy()), np.isneginf(want_ll))
    assert_stats_equal(got, want)


def test_stats_ll_wrapper_refuses_what_the_kernel_does_not_take():
    aid, qual, mapq, strand, valid, iv = on_cpu(random_tile())
    with pytest.raises(ValueError, match="allele_id"):
        cuda_kernels.stats_ll(aid.to(torch.int32), qual, mapq, strand, valid, iv, 8)
    with pytest.raises(ValueError, match="qual"):
        cuda_kernels.stats_ll(aid, None, mapq, strand, valid, iv, 8)
    with pytest.raises(ValueError, match="mapq"):
        cuda_kernels.stats_ll(
            aid, qual, None, strand, valid, iv, 8, include_alignment=True)
    with pytest.raises(ValueError, match="is_variant"):
        cuda_kernels.stats_ll(aid, qual, mapq, strand, valid, iv[:, :4], 8)
    with pytest.raises(ValueError, match="alleles"):
        cuda_kernels.stats_ll(aid, qual, mapq, strand, valid, iv, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.stats_ll(aid.t(), qual, mapq, strand, valid, iv, 8)


# --- the XLA forms ------------------------------------------------------------


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_allele_counts_match_jax(seed, K):
    aid, _q, _m, strand, valid, _iv = random_tile(K=K, seed=seed)
    want = jax_kernels.allele_counts(aid, strand, valid, K)
    got = port_kernels.allele_counts(
        *(torch.from_numpy(a) for a in (aid, strand, valid)), K)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("include_alignment", [False, True])
def test_probability_correct_matches_jax(include_alignment):
    _aid, qual, mapq, _s, valid, _iv = random_tile(seed=4)
    want = jax_kernels.probability_correct(
        qual, mapq, valid, include_alignment=include_alignment)
    got = port_kernels.probability_correct(
        *(torch.from_numpy(a) for a in (qual, mapq, valid)),
        include_alignment=include_alignment,
    )
    # One f32 pow and one or two roundings an element.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert not got[~torch.from_numpy(valid)].any()


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_genotype_log_likelihoods_match_jax(seed, K):
    aid, qual, mapq, _s, valid, _iv = random_tile(K=K, seed=seed)
    pc = np.array(jax_kernels.probability_correct(qual, mapq, valid))
    want = jax_kernels.genotype_log_likelihoods(aid, pc, valid, K)
    got = port_kernels.genotype_log_likelihoods(
        torch.from_numpy(aid), torch.from_numpy(pc), torch.from_numpy(valid), K)
    assert got.shape == (64, K * (K + 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LL_TOL)


@pytest.mark.parametrize("threshold_percent", [None, 0, 8, 50])
@pytest.mark.parametrize("K", [8, 16])
def test_tile_stats_match_jax(K, threshold_percent):
    aid, _q, _m, strand, valid, iv = random_tile(K=K, seed=K)
    want = jax_kernels.tile_stats(
        aid, strand, valid, iv, K, threshold_percent=threshold_percent)
    got = port_kernels.tile_stats(
        *(torch.from_numpy(a) for a in (aid, strand, valid, iv)), K,
        threshold_percent=threshold_percent,
    )
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("threshold_percent", [None, 0, 8, 50])
@pytest.mark.parametrize("D", [16, 15])
def test_tile_stats_nibble_match_jax(D, threshold_percent):
    K = 8
    aid, _q, _m, _s, valid, iv = random_tile(D=D, K=K, seed=D)
    packed = pack_nibbles(aid, valid)
    want = jax_kernels.tile_stats_nibble(
        packed, iv, K, threshold_percent=threshold_percent)
    got = port_kernels.tile_stats_nibble(
        torch.from_numpy(packed), torch.from_numpy(iv), K,
        threshold_percent=threshold_percent,
    )
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(
        got.candidates.numpy(), np.asarray(want.candidates))
    with pytest.raises(ValueError):
        port_kernels.tile_stats_nibble(
            torch.from_numpy(packed), torch.zeros((64, 16), dtype=torch.bool), 16)


# --- the forward step -----------------------------------------------------------


def test_entry_matches_the_jax_entry_on_its_example_tile():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import __graft_entry__ as jax_entry
    finally:
        sys.path.pop(0)
    from guacamole_tpu_torch.entry import _example_tile, entry

    jax_forward, jax_args = jax_entry.entry()
    forward, args = entry("cpu")
    for a, b in zip(args, jax_args):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_example_tile(L=64, D=16, seed=3),
                    jax_entry._example_tile(L=64, D=16, seed=3)):
        np.testing.assert_array_equal(a, b)
    want_counts, want_cand, want_ll = jax_forward(*jax_args)
    counts, candidates, ll = forward(*args)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(candidates.numpy(), np.asarray(want_cand))
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), **LL_TOL)
    # Tensors already on the device are taken as they are.
    again = forward(*dense_wire_from_numpy(*args, device=CPU)[:6])
    assert torch.equal(again[2], ll)


def test_entry_runs_on_the_card_unless_asked_otherwise():
    from guacamole_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    for requested in (None, "cuda"):
        with pytest.raises(RuntimeError, match="cpu"):
            entry(requested)
