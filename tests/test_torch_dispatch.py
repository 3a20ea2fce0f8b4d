"""The port's screen dispatch against the JAX dispatch on the same inputs.

Both run with GUAC_HOST_SCREEN=0, so the JAX side runs its XLA screens
and the port runs its kernels' plain twins (CPU tensors) through the whole
staging, slab and fetch path. Integer outputs: tolerance 0.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from guacamole_tpu.ops import dispatch as jax_dispatch
from guacamole_tpu.ops import kernels as jax_kernels
from guacamole_tpu_torch.ops import dispatch

from test_torch_kernels import csr_encode

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def device_screens(monkeypatch):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")


def tile(seed, L=600, D=40, K=8):
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    # Mostly reference reads with sparse variant evidence, as in real tiles.
    aid = np.where(rng.rand(L, D) < 0.85, 0, rng.randint(1, K, size=(L, D)))
    is_variant = np.zeros((L, K), bool)
    is_variant[:, 1:] = True
    packed, row_off = csr_encode(aid, valid, depth)
    return packed, row_off, is_variant


def small_slabs(monkeypatch, nbytes):
    """Force the slab split on both packages (the JAX one slabs at its CPU
    bound off a TPU)."""
    monkeypatch.setattr(dispatch, "CSR_SLAB_BYTES", nbytes)
    monkeypatch.setattr(jax_dispatch, "CSR_SLAB_BYTES", nbytes)


@pytest.mark.parametrize("slab_bytes", [None, 2048, 700])
@pytest.mark.parametrize("threshold_percent", [None, 25])
def test_screen_csr_launch_matches_jax(
    monkeypatch, slab_bytes, threshold_percent
):
    packed, row_off, is_variant = tile(1)
    if slab_bytes:
        small_slabs(monkeypatch, slab_bytes)
        assert len(dispatch._csr_slab_ranges(row_off, slab_bytes)) > 1
    want = jax_dispatch.screen_csr_launch(
        packed, row_off, is_variant, 8, threshold_percent=threshold_percent
    ).result()
    got = dispatch.screen_csr_launch(
        packed, row_off, is_variant, 8, threshold_percent=threshold_percent,
        device=CPU,
    ).result()
    assert got.counts.dtype == np.int16
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(want.candidates))


@pytest.mark.parametrize("slab_bytes", [None, 2048])
@pytest.mark.parametrize("threshold_percent", [None, 25])
def test_screen_csr_compact_launch_matches_jax(
    monkeypatch, slab_bytes, threshold_percent
):
    packed, row_off, is_variant = tile(2)
    if slab_bytes:
        small_slabs(monkeypatch, slab_bytes)
    for cap in (1, 4, 512):
        want = jax_dispatch.screen_csr_compact_launch(
            packed, row_off, is_variant, 8,
            threshold_percent=threshold_percent, cap=cap,
        ).result()
        got = dispatch.screen_csr_compact_launch(
            packed, row_off, is_variant, 8,
            threshold_percent=threshold_percent, cap=cap, device=CPU,
        ).result()
        assert got.total == want.total
        assert got.overflowed == want.overflowed
        np.testing.assert_array_equal(got.idx, np.asarray(want.idx))
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))


def test_compact_overflow_flag_and_roomy_roundtrip():
    packed, row_off, is_variant = tile(9, L=48, D=12)
    full = jax_kernels.tile_stats_csr(packed, row_off, is_variant, 8)
    cand_rows = np.nonzero(np.asarray(full.candidates))[0]
    n = len(cand_rows)
    assert n > 2
    # The compact screen's cap is max(cap, rows // 256); 48 rows keep it.
    roomy = dispatch.screen_csr_compact_launch(
        packed, row_off, is_variant, 8, cap=n + 8, device=CPU
    ).result()
    assert not roomy.overflowed and roomy.total == n
    np.testing.assert_array_equal(roomy.idx, cand_rows)
    np.testing.assert_array_equal(
        roomy.counts, np.asarray(full.counts)[cand_rows]
    )
    tight = dispatch.screen_csr_compact_launch(
        packed, row_off, is_variant, 8, cap=n - 1, device=CPU
    ).result()
    assert tight.overflowed and tight.total == n and len(tight.idx) == n - 1


def test_bucket_padding_is_inert():
    """Blob bytes pad to _bucket_bytes with 0xFF and slab rows pad to the
    packer's row bucket with empty rows: neither may change a count."""
    packed, row_off, is_variant = tile(5, L=32, D=16)
    assert dispatch._bucket_bytes(len(packed)) > len(packed)
    assert dispatch._bucket_bytes(len(packed)) == jax_dispatch._bucket_bytes(
        len(packed)
    )
    direct = jax_kernels.tile_stats_csr(packed, row_off, is_variant, 8)
    got = dispatch.screen_csr_launch(
        packed, row_off, is_variant, 8, device=CPU
    ).result()
    np.testing.assert_array_equal(got.counts, np.asarray(direct.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(direct.candidates))
    so, sv, nr = dispatch._pad_slab_rows(row_off, is_variant)
    assert nr == 32 and len(so) - 1 == 4096 and not sv[32:].any()
    padded = dispatch.screen_csr_launch(
        packed, so, sv, 8, device=CPU
    ).result()
    np.testing.assert_array_equal(padded.counts[:nr], got.counts)
    assert not padded.counts[nr:].any() and not padded.candidates[nr:].any()


def test_int32_offset_slab_matches_jax():
    """A slab holding a row over 64 KB ships int32 offsets in both
    packages."""
    rng = np.random.RandomState(3)
    depth = np.array([4, 131_075, 2, 0, 11])
    row_off = np.concatenate([[0], np.cumsum((depth + 1) // 2)]).astype(
        np.int32
    )
    packed = rng.randint(0, 256, size=int(row_off[-1])).astype(np.uint8)
    is_variant = rng.rand(5, 8) < 0.5
    want = jax_dispatch.screen_csr_launch(packed, row_off, is_variant, 8)
    got = dispatch.screen_csr_launch(
        packed, row_off, is_variant, 8, device=CPU
    ).result()
    want = want.result()
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(want.candidates))


def test_wire_form_rejects_offsets_outside_the_blob():
    packed, row_off, is_variant = tile(4, L=8, D=8)
    bad = row_off.copy()
    bad[-1] = len(packed) + 1
    with pytest.raises(ValueError):
        dispatch.wire_from_numpy(packed, bad, is_variant, CPU)
    with pytest.raises(ValueError):
        dispatch.wire_from_numpy(packed, row_off + 1, is_variant, CPU)
    with pytest.raises(ValueError):
        dispatch.wire_from_numpy(packed, row_off, is_variant[:-1], CPU)


def test_screen_policy(monkeypatch):
    cuda = torch.device("cuda")

    def skips_nibbles(device, mesh=None):
        plan = dispatch.ScreenPlan("counts", device=device, mesh=mesh)
        return plan.pack_args(0)["skip_nibbles"]

    monkeypatch.delenv("GUAC_HOST_SCREEN")
    assert dispatch.screen_on_host(CPU)
    assert not dispatch.screen_on_host(cuda)
    # No kernel could run on a GPU if the packer skipped the blob.
    assert not skips_nibbles(cuda)
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1")
    assert dispatch.screen_on_host(cuda) and skips_nibbles(cuda)
    # A mesh always runs device screens, so its tiles keep their blob.
    assert not skips_nibbles(CPU, mesh=object())
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    assert not dispatch.screen_on_host(CPU)
    assert not skips_nibbles(CPU)


def test_host_counts_screen_matches_device_screen():
    packed, row_off, is_variant = tile(6)
    counts = np.asarray(
        jax_kernels.csr_screen_math(packed, row_off, is_variant, 8, 25)[0]
    )
    full = dispatch.screen_csr_launch(
        packed, row_off, is_variant, 8, threshold_percent=25, device=CPU
    ).result()
    host = dispatch._HostCountsScreen(counts, is_variant, 25, False).result()
    np.testing.assert_array_equal(host.candidates, full.candidates)
    compact = dispatch._HostCountsScreen(counts, is_variant, 25, True).result()
    np.testing.assert_array_equal(compact.idx, np.flatnonzero(full.candidates))


def _tiles_both_packers():
    """Screen tiles of the same reads from the Python packer (dense tiles,
    no CSR blob) and the native columnar packer (CSR blob + counts)."""
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
    sources = (
        ReadSource.from_reads(reads),
        ReadSource.from_columnar(columnar_from_reads(reads, native=True)),
    )
    return [
        tile for source in sources
        for tile in source.iter_tiles("chr1", loci, fields="screen")
    ]


@pytest.mark.parametrize("threshold_percent", [None, 8])
def test_screen_tile_for_object_and_native_tiles_match_jax(threshold_percent):
    tiles = _tiles_both_packers()
    assert {t.csr_nib is None for t in tiles} == {True, False}
    for tile in tiles:
        want = jax_dispatch.screen_tile_for(
            tile, threshold_percent=threshold_percent
        )
        got = dispatch.screen_tile_for(
            tile, threshold_percent=threshold_percent, device=CPU
        )
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(
            got.candidates, np.asarray(want.candidates)
        )


@pytest.mark.parametrize("compact_cap", [None, 512])
def test_pipelined_screens_host_and_device_agree(monkeypatch, compact_cap):
    tiles = _tiles_both_packers()

    def screens(host):
        monkeypatch.setenv("GUAC_HOST_SCREEN", host)
        plan = dispatch.ScreenPlan(
            "counts", device=CPU, threshold_percent=8, compact_cap=compact_cap
        )
        return [p.result() for _t, p in plan.screens(iter(tiles), lambda t: t)]

    for dev, host in zip(screens("0"), screens("1")):
        for a, b in zip(dev, host):
            np.testing.assert_array_equal(a, b)


def test_prefetch_iter_order_and_errors():
    assert list(dispatch.prefetch_iter(iter(range(50)), ahead=3)) == list(
        range(50)
    )

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = dispatch.prefetch_iter(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_pipelined_holds_its_window():
    """At most max_in_flight + 1 launches run ahead of the consumer."""
    launched = []
    it = dispatch.pipelined(range(10), launched.append, max_in_flight=1)
    assert next(it)[0] == 0 and launched == [0, 1]
    assert next(it)[0] == 1 and launched == [0, 1, 2]
    assert [item for item, _ in it] == list(range(2, 10))


def test_transfer_stats_lose_no_updates_under_threads():
    """TRANSFER_STATS takes a lock: concurrent updates from more threads
    than cores, with a short switch interval, must all land."""
    dispatch.reset_transfer_stats()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [
                    dispatch._count(h2d_bytes=3, launches=1)
                    for _ in range(2000)
                ]
            )
            for _ in range(16)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert dispatch.TRANSFER_STATS["launches"] == 16 * 2000
    assert dispatch.TRANSFER_STATS["h2d_bytes"] == 3 * 16 * 2000
    dispatch.reset_transfer_stats()


# --- the dense-tile route ------------------------------------------------------


def dense_tile(seed, L=300, D=15, K=8):
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, D + 1, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    aid = np.where(
        valid,
        np.where(rng.rand(L, D) < 0.85, 0, rng.randint(1, K, size=(L, D))),
        -1,
    ).astype(np.int16)
    qual = np.where(valid, rng.randint(2, 45, size=(L, D)), 0).astype(np.int16)
    mapq = np.where(valid, rng.randint(0, 70, size=(L, D)), 0).astype(np.int16)
    strand = valid & (rng.rand(L, D) < 0.5)
    is_variant = rng.rand(L, K) < 0.4
    return aid, qual, mapq, strand, valid, is_variant


@pytest.mark.parametrize("threshold_percent", [None, 8, 50])
@pytest.mark.parametrize(
    "branch, K", [("nibble", 8), ("many_alleles", 16), ("dense_switch", 8)],
)
def test_screen_tile_launch_matches_jax_in_each_branch(
    monkeypatch, branch, K, threshold_percent
):
    """The two branches of screen_tile_launch against the JAX
    screen_tile_launch (its nibble screen, or XLA's tile_stats for
    K > 15), and screen_dense_launch at K = 8 (dense_switch, the JAX
    package's fused Pallas route) against the same; the dense results
    also against the fused Pallas kernel interpreted: the port's one
    dense kernel serves both."""
    from guacamole_tpu.ops.pallas_kernels import fused_tile_stats_ll

    planes = dense_tile(K, K=K)
    want = jax_dispatch.screen_tile_launch(
        *planes, K, threshold_percent=threshold_percent
    ).result()
    launched = []
    real = dispatch.screen_dense_launch
    monkeypatch.setattr(
        dispatch, "screen_dense_launch",
        lambda *a, **k: launched.append(1) or real(*a, **k),
    )
    if branch == "dense_switch":
        aid, _q, _m, strand, valid, iv = planes
        got = dispatch.screen_dense_launch(
            aid, strand, valid, iv, K, threshold_percent, device=CPU
        ).result()
    else:
        got = dispatch.screen_tile_launch(
            *planes, K, threshold_percent=threshold_percent, device=CPU
        ).result()
    assert bool(launched) == (branch != "nibble")
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(want.candidates))
    same = dispatch.screen_tile(
        *planes, K, threshold_percent=threshold_percent, device=CPU)
    np.testing.assert_array_equal(same.counts, got.counts)
    if branch == "nibble":
        assert got.depth is None and got.forward_counts is None
        return
    fused = fused_tile_stats_ll(
        *(np.asarray(p) for p in planes), K,
        threshold_percent=threshold_percent, interpret=True,
    )
    for name in ("counts", "forward_counts", "depth", "candidates"):
        np.testing.assert_array_equal(
            getattr(got, name), np.asarray(getattr(fused, name)), name)


def test_dense_launch_slabs_concatenate(monkeypatch):
    planes = dense_tile(3, L=1000, D=16)
    aid, _q, _m, strand, valid, iv = planes
    one = dispatch.screen_dense_launch(
        aid, strand, valid, iv, 8, 8, device=CPU).result()
    monkeypatch.setattr(dispatch, "DENSE_SLAB_CELLS", 256 * 16)
    dispatch.reset_transfer_stats()
    many = dispatch.screen_dense_launch(
        aid, strand, valid, iv, 8, 8, device=CPU).result()
    assert dispatch.TRANSFER_STATS["launches"] == 4
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] == 1000


def test_dense_wire_keeps_the_tiles_types_and_skips_unread_planes():
    planes = dense_tile(4)
    wire = dispatch.dense_wire_from_numpy(*planes, device=CPU)
    assert [t.dtype for t in wire[:6]] == [
        torch.int16, torch.int16, torch.int16, torch.bool, torch.bool,
        torch.bool,
    ]
    for t, a in zip(wire[:6], planes):
        np.testing.assert_array_equal(t.numpy(), a)
    # Wider integers, as an entry point's caller may hold them, narrow.
    wide = dispatch.dense_wire_from_numpy(
        planes[0].astype(np.int64), planes[1].astype(np.int32), *planes[2:],
        device=CPU)
    assert torch.equal(wide.allele_id, wire.allele_id)
    assert torch.equal(wide.qual, wire.qual)
    bare = dispatch.dense_wire_from_numpy(
        planes[0], None, None, *planes[3:], device=CPU)
    assert bare.qual is None and bare.mapq is None
    assert len(bare.staged_from) == 4
    with pytest.raises(ValueError, match="strand"):
        dispatch.dense_wire_from_numpy(
            planes[0], None, None, planes[3][:, :4], *planes[4:], device=CPU)


def test_screen_packed_launch_matches_jax():
    aid, _q, _m, _s, valid, iv = dense_tile(5)
    packed = dispatch.pack_nibbles(aid, valid)
    want = jax_dispatch.screen_packed_launch(packed, iv, 8, 8).result()
    got = dispatch.screen_packed_launch(packed, iv, 8, 8, device=CPU).result()
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(want.candidates))


def _full_tiles(max_alleles=8, **pack_args):
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
    sources = (
        ReadSource.from_reads(reads),
        ReadSource.from_columnar(columnar_from_reads(reads, native=True)),
    )
    pack_args.setdefault("fields", "screen")
    return [
        tile for source in sources
        for tile in source.iter_tiles(
            "chr1", loci, max_alleles=max_alleles, **pack_args)
    ]


def _spy(monkeypatch, names):
    """Record, in order, each call of the named dispatch functions."""
    calls = []
    for name in names:
        real = getattr(dispatch, name)
        monkeypatch.setattr(
            dispatch, name,
            lambda *a, _name=name, _real=real, **k: (
                calls.append(_name) or _real(*a, **k)),
        )
    return calls


@pytest.mark.parametrize("host_screen", ["0", "1"])
@pytest.mark.parametrize("compact_cap", [None, 512])
def test_dense_switch_packs_full_tiles_and_screens_them(
    monkeypatch, compact_cap, host_screen
):
    """Tiles of more than 15 alleles pack full whatever fields the screen
    asks for, and the screen plan and screen_tile_for take the dense
    kernel, with host screens as with device screens (the packer has no
    counts for them); the counts and flags are the JAX package's at the
    same max_alleles."""
    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    plan = dispatch.ScreenPlan(
        "counts", device=CPU, threshold_percent=8, compact_cap=compact_cap
    )
    tiles = _full_tiles(**plan.pack_args(0, 16))
    assert all(t.allele_id is not None and t.csr_nib is None for t in tiles)
    launched = _spy(monkeypatch, ["screen_dense_launch"])
    screened = [
        p.result() for _t, p in plan.screens(iter(tiles), lambda t: t)
    ]
    assert len(launched) == len(screened) == len(tiles) == 2
    for tile, got in zip(tiles, screened):
        want = jax_kernels.tile_stats(
            tile.allele_id, tile.strand, tile.valid, tile.is_variant, 16,
            threshold_percent=8,
        )
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(
            got.candidates, np.asarray(want.variant_evidence))
        assert got.depth is not None
        again = dispatch.screen_tile_for(tile, threshold_percent=8, device=CPU)
        np.testing.assert_array_equal(again.counts, got.counts)


def test_sixteen_alleles_take_the_dense_kernel_without_the_switch():
    tiles = _full_tiles(max_alleles=16)
    assert all(t.K == 16 and t.allele_id is not None for t in tiles)
    for tile in tiles:
        want = jax_kernels.tile_stats(
            tile.allele_id, tile.strand, tile.valid, tile.is_variant, 16,
            threshold_percent=8,
        )
        got = dispatch.screen_tile_for(tile, threshold_percent=8, device=CPU)
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(
            got.candidates, np.asarray(want.variant_evidence))
    plan = dispatch.ScreenPlan(
        "counts", device=CPU, threshold_percent=8, compact_cap=512)
    piped = [p.result() for _t, p in plan.screens(iter(tiles), lambda t: t)]
    assert all(isinstance(r, dispatch.ScreenResult) for r in piped)


def test_dense_route_refuses_a_reduced_tile():
    """A tile of 16 alleles without its per-element planes cannot take the
    dense kernel: screen_tile_for and the screen plan refuse it."""
    import dataclasses

    tile = next(t for t in _tiles_both_packers() if t.allele_id is None)
    tile = dataclasses.replace(
        tile, is_variant=np.zeros((tile.L, 16), bool), counts32=None)
    with pytest.raises(ValueError, match="fields='full'"):
        dispatch.screen_tile_for(tile, device=CPU)
    plan = dispatch.ScreenPlan("counts", device=CPU)
    with pytest.raises(ValueError, match="fields='full'"):
        list(plan.screens(iter([tile]), lambda t: t))


# The launches each tile form reaches, by kind of screen and where it
# runs (host, device or a mesh of two CPU shards): "host" is a screen the
# packer computed (no launch). A mesh never takes the dense route (its
# wire forms hold 15 alleles); an empty tile launches nothing anywhere.
_CSR = ["screen_csr_launch"]
_COMPACT = ["screen_csr_compact_launch"]
_DENSE = ["screen_tile_launch", "screen_dense_launch"]
_NIBBLE = ["screen_tile_launch", "screen_csr_launch"]
_GERMLINE = ["germline_screen_launch", "ll_screen_arrays_launch"]
_TUMOR = ["tumor_screen_launch", "ll_screen_arrays_launch"]
_ROUTES = {
    # kind: {where: (native K = 8, Python-packed K = 8, native K = 16)}
    "counts": {"host": ("host", _CSR, _DENSE),
               "device": (_CSR, _CSR, _DENSE),
               "mesh": (_CSR, _CSR, None)},
    "counts_compact": {"host": ("host", _COMPACT, _DENSE),
                       "device": (_COMPACT, _COMPACT, _DENSE),
                       "mesh": (_CSR, _CSR, None)},
    "germline": {"host": ("host", _GERMLINE, _DENSE),
                 "device": (_GERMLINE, _GERMLINE, _DENSE),
                 "mesh": (_GERMLINE, _GERMLINE, None)},
    "tumor": {"host": ("host", _NIBBLE, _DENSE),
              "device": (_TUMOR, _NIBBLE, _DENSE),
              "mesh": (_TUMOR, ["ll_screen_arrays_launch"], None)},
}


@pytest.mark.parametrize("where", ["host", "device", "mesh"])
@pytest.mark.parametrize("kind", list(_ROUTES))
def test_screen_plan_packs_and_routes_each_tile_form(monkeypatch, kind, where):
    from types import SimpleNamespace

    from guacamole_tpu_torch.parallel.mesh import loci_mesh

    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if where == "host" else "0")
    mesh = loci_mesh([CPU] * 2) if where == "mesh" else None
    plan = dispatch.ScreenPlan(
        kind.split("_")[0], device=CPU, mesh=mesh,
        threshold_percent=8 if kind.startswith("counts") else None,
        compact_cap=512 if kind == "counts_compact" else None,
        min_mapq=0 if kind.startswith("counts") else 1,
        min_phred=5.0 if kind == "germline" else 0.0,
    )
    host = where == "host"
    likelihood = not kind.startswith("counts")
    fields = {"germline": "likelihood", "tumor": "likelihood_mapq"}
    assert plan.pack_args(0) == dict(
        tile_size=4096 if likelihood and mesh else 0,
        max_alleles=8,
        fields=fields[kind] if likelihood and not host else "screen",
        min_mapq=1 if likelihood else 0,
        ll_screen_margin=0.5 if host and likelihood else 0.0,
        ll_screen_kind=2 if kind == "tumor" else 1,
        skip_nibbles=host,
        ll_screen_min_phred=5.0 if host and kind == "germline" else 0.0,
    )
    assert plan.pack_args(1024)["tile_size"] == 1024
    # Above 15 alleles the packer builds full tiles whatever the screen.
    assert plan.pack_args(0, 16)["fields"] == "full"
    python8, native8 = _full_tiles(**plan.pack_args(0))
    _python16, native16 = _full_tiles(**plan.pack_args(0, 16))
    empty = SimpleNamespace(L=0)
    calls = _spy(monkeypatch, [
        "screen_csr_launch", "screen_csr_compact_launch", "screen_tile_launch",
        "screen_dense_launch", "germline_screen_launch",
        "tumor_screen_launch", "ll_screen_arrays_launch",
    ])
    forms = [native8, python8, native16][: 2 if mesh else 3]
    for tile, want in zip(forms, _ROUTES[kind][where]):
        calls.clear()
        out = list(plan.screens(iter([empty, tile]), lambda t: t))
        assert [item for item, _ in out] == [empty, tile]
        assert out[0][1] is None and out[1][1].result() is not None
        assert calls == ([] if want == "host" else want), (kind, where)


@pytest.fixture(scope="module")
def scale_fixture(tmp_path_factory):
    from guacamole_tpu_torch.utils.simulate import make_scale_fixture

    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _call_keys(caller, calls):
    if caller == "germline_threshold":
        return [str(c.to_vcf_record()) for c in calls]
    if caller == "germline_standard":
        return [
            (c.reference_contig, c.start, c.allele.ref_bases,
             c.allele.alt_bases, c.evidence.read_depth,
             np.float64(c.evidence.likelihood).tobytes())
            for c in calls
        ]
    return [
        (c.reference_contig, c.start, c.allele.ref_bases, c.allele.alt_bases,
         np.float64(c.somatic_log_odds).tobytes())
        for c in calls
    ]


@pytest.mark.parametrize(
    "command", ["germline-threshold", "germline-standard", "somatic-standard"]
)
def test_dense_switch_gives_each_callers_default_vcf(
    monkeypatch, scale_fixture, command
):
    """max_alleles=16 through each caller's Python API (no CLI option sets
    it) packs full tiles and screens them with the dense kernel; the calls
    are the JAX package's at the same max_alleles, and the port's at the
    default 8 alleles."""
    import importlib

    from guacamole_tpu.callers.common import load_read_source as jax_load
    from guacamole_tpu.loci.lociset import parse_loci as jax_parse_loci
    from guacamole_tpu.loci.partition import (
        partition_loci_uniformly as jax_partition,
    )
    from guacamole_tpu.reads.read import InputFilters as JaxFilters
    from guacamole_tpu_torch.callers.common import load_read_source
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly
    from guacamole_tpu_torch.reads.read import InputFilters

    caller = command.replace("-", "_")
    loci = "deep1m:0-12000" + (
        ",shallow8m:0-60000" if caller == "germline_standard" else "")
    files = {"somatic_standard": ["tumor_bam", "normal_bam"]}.get(
        caller, ["germline_bam"])
    kwargs = {
        "germline_threshold": dict(threshold_percent=25),
        "germline_standard": dict(min_alignment_quality=1),
        "somatic_standard": dict(odds_threshold=20),
    }[caller]

    def call(pkg, load, filters, parse, partition, max_alleles, **extra):
        fn = importlib.import_module(f"{pkg}.callers.{caller}").call_variants
        sources = [
            load(scale_fixture[f], filters.create(
                non_duplicate=True, has_mdtag=True))[0]
            for f in files
        ]
        return _call_keys(caller, fn(
            *sources, partition(2, parse(loci).result()),
            max_alleles=max_alleles, **kwargs, **extra))

    want = call("guacamole_tpu", jax_load, JaxFilters, jax_parse_loci,
                jax_partition, 16)
    port = ("guacamole_tpu_torch", load_read_source, InputFilters,
            parse_loci, partition_loci_uniformly)
    dense_launches = _spy(monkeypatch, ["screen_dense_launch"])
    default = call(*port, 8, device=CPU)
    assert not dense_launches
    got = call(*port, 16, device=CPU)
    assert dense_launches
    assert got == want == default and got
