"""The likelihood candidate screen of the port against the JAX package.

Seeded numpy inputs go through the JAX screens (the XLA forms, and the
Pallas kernel in interpret mode) and through the port's plain PyTorch
versions on the CPU, which are what the ll_screen CUDA kernel is held to
on the card. The flags come out of f32 sums, so they are not integers
underneath: on these pinned seeds and shapes (those of
tests/test_pallas_kernels.py) they must EQUAL the JAX flags; on any input
they must be a superset of the exact f64 rule.
"""

import numpy as np
import pytest
import torch

from guacamole_tpu.ops import dispatch as jax_dispatch
from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu.ops.pallas_kernels import pallas_likelihood_screen
from guacamole_tpu_torch.ops import cuda_kernels, dispatch, kernels

CPU = torch.device("cpu")
K = 8


def ll_fixture(seed, L=64, D=24, min_depth=0):
    """The tile of tests/test_pallas_kernels.py (_ll_fixture; min_depth=1
    and L=48 give the tile of its f64-argmax test): extreme quals 0..93,
    where f32's 1 - err rounds to 1, and q = 0, where log(2 - 2err) is
    -inf."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(min_depth, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = np.where(valid, rng.randint(0, 4, size=(L, D)), -1)
    qual = np.where(valid, rng.choice([0, 2, 20, 41, 70, 93], size=(L, D)), 0)
    mapq = np.where(valid, rng.choice([0, 10, 37, 60, 254], size=(L, D)), 0)
    is_variant = np.zeros((L, K), bool)
    is_variant[:, 1:4] = True
    is_standard = np.zeros((L, K), bool)
    is_standard[:, :4] = True
    ll_pack = np.where(
        valid, (aid & 0xF) | (qual.astype(np.uint16) << 4), 0xFFFF
    ).astype(np.uint16)
    return ll_pack, mapq.astype(np.uint8), is_variant, is_standard


def byte_form(ll_pack):
    """(ll_pack8, ll_qvals) of a uint16 tile with at most 16 quals."""
    quals = np.unique((ll_pack >> 4)[ll_pack != 0xFFFF])
    assert len(quals) <= 16
    lut = np.zeros(4096, np.uint16)
    lut[quals] = np.arange(len(quals))
    pack8 = np.where(
        ll_pack == 0xFFFF, 0xFF, (ll_pack & 0xF) | (lut[ll_pack >> 4] << 4)
    ).astype(np.uint8)
    return pack8, quals.astype(np.uint8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_flags(ll_pack, mapq, iv, sa, min_phred=0.0, qvals=None):
    """Through the wrapper (on the CPU: the plain version), from the wire
    form that the dispatch stages."""
    wire = dispatch.ll_wire_from_numpy(ll_pack, mapq, iv, sa, qvals, CPU)
    return cuda_kernels.ll_screen(
        wire.pack, wire.flag_words, K, 0.5, min_phred,
        ll_qvals=wire.qvals, ll_mapq=wire.mapq,
    ).numpy()


def exact_rule(ll_pack, mapq, iv, sa, min_phred=0.0):
    """The f64 rule, term by term and pair by pair (no factoring): the
    loci whose exact argmax genotype is variant and, with min_phred, whose
    exact normalized best probability passes the filter."""
    L, D = ll_pack.shape
    valid = ll_pack != 0xFFFF
    aid = (ll_pack & 0xF).astype(int)
    pc = 1.0 - 10.0 ** ((ll_pack >> 4).astype(np.float64) / -10.0)
    if mapq is not None:
        pc = pc * (1.0 - 10.0 ** (mapq.astype(np.float64) / -10.0))
    out = np.zeros(L, bool)
    for li in range(L):
        scores = []
        for i in range(K):
            for j in range(i, K):
                if not (sa[li, i] and sa[li, j]):
                    continue
                pi = np.where(aid[li] == i, pc[li], 1.0 - pc[li])
                pj = np.where(aid[li] == j, pc[li], 1.0 - pc[li])
                with np.errstate(divide="ignore"):
                    s = np.log(pi + pj)[valid[li]].sum()
                scores.append((s, iv[li, i] or iv[li, j]))
        if not scores or not valid[li].any():
            continue
        smax = max(s for s, _ in scores)
        if not any(v for s, v in scores if s == smax):
            continue
        if min_phred > 0 and np.isfinite(smax):
            total = sum(np.exp(s - smax) for s, _ in scores)
            one_minus = 1.0 - (1.0 / total - 1e-10)
            gq = np.inf if one_minus <= 0 else -10.0 * np.log10(one_minus)
            if round(gq) < min_phred:
                continue
        out[li] = True
    return out


@pytest.mark.parametrize("min_phred", [0.0, 10.0, 40.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_germline_flags_equal_jax_and_pallas(seed, min_phred):
    ll_pack, _mapq, iv, sa = ll_fixture(seed)
    want = np.asarray(jax_kernels.germline_likelihood_screen(
        ll_pack, iv, sa, K, min_phred=min_phred))
    pallas = np.asarray(pallas_likelihood_screen(
        ll_pack, None, iv, sa, K, interpret=True, min_phred=min_phred))
    got = kernels.germline_screen_math(
        t(ll_pack), t(iv), t(sa), K, min_phred=min_phred).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        port_flags(ll_pack, None, iv, sa, min_phred), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tumor_flags_equal_jax_and_pallas(seed):
    ll_pack, mapq, iv, sa = ll_fixture(seed)
    want = np.asarray(
        jax_kernels.tumor_likelihood_screen(ll_pack, mapq, iv, sa, K))
    pallas = np.asarray(pallas_likelihood_screen(
        ll_pack, mapq, iv, sa, K, include_alignment=True, interpret=True))
    got = kernels.tumor_screen_math(
        t(ll_pack), t(mapq), t(iv), t(sa), K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(port_flags(ll_pack, mapq, iv, sa), want)


@pytest.mark.parametrize("tumor", [False, True])
@pytest.mark.parametrize("min_phred", [0.0, 40.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byte_form_equals_uint16_form_and_jax(seed, min_phred, tumor):
    if tumor and min_phred > 0:
        min_phred = 0.0  # the GQ gate is a germline-only emission bound
    ll_pack, mapq, iv, sa = ll_fixture(seed)
    mapq = mapq if tumor else None
    pack8, qvals = byte_form(ll_pack)
    wide = port_flags(ll_pack, mapq, iv, sa, min_phred)
    byte = port_flags(pack8, mapq, iv, sa, min_phred, qvals)
    np.testing.assert_array_equal(byte, wide)
    if tumor:
        want = jax_kernels.tumor_likelihood_screen8(
            pack8, qvals, mapq, iv, sa, K)
        direct = kernels.tumor_screen_math8(
            t(pack8), t(qvals), t(mapq), t(iv), t(sa), K)
    else:
        want = jax_kernels.germline_likelihood_screen8(
            pack8, qvals, iv, sa, K, min_phred=min_phred)
        direct = kernels.germline_screen_math8(
            t(pack8), t(qvals), t(iv), t(sa), K, min_phred=min_phred)
    np.testing.assert_array_equal(byte, np.asarray(want))
    np.testing.assert_array_equal(direct.numpy(), np.asarray(want))


@pytest.mark.parametrize("tumor", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_flags_are_a_superset_of_the_f64_argmax(seed, tumor):
    ll_pack, mapq, iv, sa = ll_fixture(seed, L=48, min_depth=1)
    mapq = mapq if tumor else None
    exact = exact_rule(ll_pack, mapq, iv, sa)
    got = port_flags(ll_pack, mapq, iv, sa)
    assert exact.any()
    assert not (exact & ~got).any()
    # The same rule through the port's own f64 path: what chip_smoke.py
    # holds the CUDA kernel to on the card.
    c, g, any_valid = kernels.ll_allele_sums(
        t(ll_pack), K, None, None if mapq is None else t(mapq),
        dtype=torch.float64)
    parts = kernels.screen_parts(c, g, t(iv), t(sa), K)
    f64 = parts.has_var & any_valid & (parts.best_variant >= parts.best_ref)
    assert not (f64.numpy() & ~got).any()
    assert not (exact & ~f64.numpy()).any()


@pytest.mark.parametrize("min_phred", [10.0, 40.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gq_gate_only_removes_and_keeps_what_passes_exactly(seed, min_phred):
    ll_pack, _mapq, iv, sa = ll_fixture(seed)
    ungated = port_flags(ll_pack, None, iv, sa)
    gated = port_flags(ll_pack, None, iv, sa, min_phred)
    assert not (gated & ~ungated).any()
    assert (ungated & ~gated).any()  # the gate does something here
    assert not (exact_rule(ll_pack, None, iv, sa, min_phred) & ~gated).any()


def test_all_empty_rows_and_minus_infinity_rows():
    """-inf >= -inf is true in IEEE: rows with no standard variant allele,
    or with no valid element, are never candidates; a row whose every
    score is -inf (all q = 0) keeps its flag through the GQ gate."""
    ll_pack = np.full((4, 8), 0xFFFF, np.uint16)
    ll_pack[1, :4] = [0, 0, 1, 1]  # q = 0: log(2 - 2err) = -inf
    ll_pack[2, :4] = [0 | 30 << 4, 1 | 30 << 4, 1 | 30 << 4, 1 | 30 << 4]
    ll_pack[3, :4] = ll_pack[2, :4]
    iv = np.zeros((4, K), bool)
    iv[:, 1] = True
    sa = np.zeros((4, K), bool)
    sa[:, :2] = True
    sa[3, 1] = False  # the variant allele is not a standard one
    for min_phred in (0.0, 40.0):
        want = np.asarray(jax_kernels.germline_likelihood_screen(
            ll_pack, iv, sa, K, min_phred=min_phred))
        got = port_flags(ll_pack, None, iv, sa, min_phred)
        np.testing.assert_array_equal(got, want)
        assert got.tolist()[0] is False and got.tolist()[3] is False
    assert port_flags(ll_pack, None, iv, sa).tolist()[1:3] == [True, True]


@pytest.mark.parametrize("k", [1, 2, 8, 15])
def test_pack_flag_words_equal_jax_bit_for_bit(k):
    rng = np.random.RandomState(k)
    iv = rng.rand(257, k) < 0.5
    sa = rng.rand(257, k) < 0.5
    got = dispatch.pack_flag_words(iv, sa)
    want = jax_dispatch.pack_flag_words(iv, sa)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    iv2, sa2 = kernels.unpack_flag_words(t(got.view(np.int32)), k)
    np.testing.assert_array_equal(iv2.numpy(), iv)
    np.testing.assert_array_equal(sa2.numpy(), sa)


@pytest.mark.parametrize("k", [16, 17])
def test_pack_flag_words_refuses_more_than_15_alleles(k):
    planes = np.ones((3, k), bool)
    with pytest.raises(ValueError, match="15"):
        dispatch.pack_flag_words(planes, planes)


def test_pack_flag_words_refuses_unequal_planes():
    with pytest.raises(ValueError):
        dispatch.pack_flag_words(np.ones((3, 4), bool), np.ones((3, 5), bool))


@pytest.mark.parametrize("tumor", [False, True])
@pytest.mark.parametrize("byte", [False, True])
def test_arrays_launch_equals_jax_launch(monkeypatch, byte, tumor):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    ll_pack, mapq, iv, sa = ll_fixture(5, L=300, D=24)
    mapq = mapq if tumor else None
    qvals = None
    if byte:
        ll_pack, qvals = byte_form(ll_pack)
    min_phred = 0.0 if tumor else 40.0
    want = jax_dispatch.candidates_of(jax_dispatch.ll_screen_arrays_launch(
        ll_pack, mapq, iv, sa, K, min_phred=min_phred, ll_qvals=qvals,
    ).result())
    pending = dispatch.ll_screen_arrays_launch(
        ll_pack, mapq, iv, sa, K, min_phred=min_phred, ll_qvals=qvals,
        device=CPU,
    )
    got = dispatch.candidates_of(pending.result())
    assert got.dtype == bool and got.shape == (300,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slab_cells", [256 * 24, 300 * 24, 1 << 20])
def test_slabs_are_inert(monkeypatch, slab_cells):
    """A tile split into row slabs gives the mask of the whole tile, and
    appended all-empty rows flag nothing."""
    ll_pack, _mapq, iv, sa = ll_fixture(7, L=700, D=24)
    whole = port_flags(ll_pack, None, iv, sa, 40.0)
    monkeypatch.setattr(dispatch, "LL_SLAB_CELLS", slab_cells)
    launches = dispatch.TRANSFER_STATS["launches"]
    pending = dispatch.ll_screen_arrays_launch(
        ll_pack, None, iv, sa, K, min_phred=40.0, device=CPU)
    n = dispatch.TRANSFER_STATS["launches"] - launches
    assert n == -(-700 // max(256, slab_cells // 24))
    np.testing.assert_array_equal(pending.result(), whole)
    padded = np.concatenate([ll_pack, np.full((60, 24), 0xFFFF, np.uint16)])
    flags = port_flags(
        padded, None, np.concatenate([iv, np.ones((60, K), bool)]),
        np.concatenate([sa, np.ones((60, K), bool)]), 40.0)
    np.testing.assert_array_equal(flags[:700], whole)
    assert not flags[700:].any()


def _likelihood_tiles(fields):
    """Likelihood tiles of the same reads from the native columnar packer
    (ll_pack8 + qual dictionary) and, as full tiles, from the Python
    packer (no native ll_pack: ll_pack_of packs the uint16 form)."""
    from guacamole_tpu_torch.callers.source import ReadSource
    from guacamole_tpu_torch.loci.lociset import LociSet
    from guacamole_tpu_torch.runtime.columnar import columnar_from_reads
    from test_pack import synthetic_reads

    reads = sorted(
        (r for r in synthetic_reads()
         if r.cigar.read_length == len(r.sequence)),
        key=lambda r: r.start,
    )
    loci = LociSet.of("chr1", 0, 20).on_contig("chr1")
    native = ReadSource.from_columnar(columnar_from_reads(reads, native=True))
    return (
        list(native.iter_tiles("chr1", loci, fields=fields, min_mapq=1)),
        list(ReadSource.from_reads(reads).iter_tiles("chr1", loci)),
    )


@pytest.mark.parametrize("min_phred", [0.0, 30.0])
def test_germline_screen_launch_equals_jax_on_packed_tiles(
    monkeypatch, min_phred
):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    native, python = _likelihood_tiles("likelihood")
    assert native and python
    assert all(getattr(tl, "ll_pack", None) is None for tl in python)
    assert any(
        getattr(tl, "ll_pack8", None) is not None
        or getattr(tl, "ll_pack", None) is not None
        for tl in native
    )
    for tile, min_mapq in [(tl, 1) for tl in native] + [
        (tl, 0) for tl in python
    ]:
        want = jax_dispatch.candidates_of(jax_dispatch.germline_screen_launch(
            tile, min_mapq=min_mapq, min_phred=min_phred).result())
        got = dispatch.germline_screen_launch(
            tile, min_mapq=min_mapq, min_phred=min_phred, device=CPU
        ).result()
        np.testing.assert_array_equal(got, want[: len(got)])


def test_tumor_screen_launch_equals_jax_on_packed_tiles(monkeypatch):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    native, _python = _likelihood_tiles("likelihood_mapq")
    assert native
    for tile in native:
        want = jax_dispatch.candidates_of(
            jax_dispatch.tumor_screen_launch(tile, min_mapq=1).result())
        got = dispatch.tumor_screen_launch(
            tile, min_mapq=1, device=CPU).result()
        np.testing.assert_array_equal(got, want[: len(got)])
        with pytest.raises(ValueError, match="min_mapq"):
            dispatch.tumor_screen_launch(tile, min_mapq=7, device=CPU)


def test_pending_candidates_takes_a_host_mask_and_pipelined_keeps_order():
    mask = np.array([True, False, True])
    assert dispatch.PendingCandidates(mask).result() is mask
    assert dispatch.candidates_of(mask) is mask
    out = list(dispatch.pipelined(range(20), lambda i: i * i, max_in_flight=3))
    assert out == [(i, i * i) for i in range(20)]


@pytest.mark.parametrize(
    "kwargs, error",
    [
        (dict(pack=np.zeros((2, 8), np.uint8)), "qual dictionary"),
        (dict(pack=np.zeros((2, 8), np.uint16), qvals=[30]), "no qual"),
        (dict(pack=np.zeros((2, 8), np.int16)), "uint8 or uint16"),
        (dict(pack=np.zeros((2, 8), np.uint8), qvals=list(range(17))),
         "at most 16"),
        (dict(pack=np.zeros((2, 8), np.uint16), k=16), "15"),
        (dict(pack=np.zeros((2, 8), np.uint16), words=3), "rows"),
        (dict(pack=np.zeros((2, 8), np.uint16),
              mapq=np.zeros((2, 4), np.uint8)), "ll_mapq"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(kwargs, error):
    pack = t(kwargs["pack"])
    words = torch.zeros(kwargs.get("words", 2), dtype=torch.int32)
    mapq = kwargs.get("mapq")
    with pytest.raises(ValueError, match=error):
        cuda_kernels.ll_screen(
            pack, words, kwargs.get("k", K), ll_qvals=kwargs.get("qvals"),
            ll_mapq=None if mapq is None else t(mapq),
        )


def test_plain_version_counts_no_launch():
    before = cuda_kernels.LAUNCHES["ll_screen"]
    ll_pack, _mapq, iv, sa = ll_fixture(0)
    port_flags(ll_pack, None, iv, sa)
    assert cuda_kernels.LAUNCHES["ll_screen"] == before
