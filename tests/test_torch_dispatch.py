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
    monkeypatch.delenv("GUAC_HOST_SCREEN")
    assert dispatch.screen_on_host(CPU)
    assert not dispatch.screen_on_host(cuda)
    # No kernel could run on a GPU if the packer skipped the blob.
    assert not dispatch.pack_skip_nibbles(cuda)
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1")
    assert dispatch.screen_on_host(cuda) and dispatch.pack_skip_nibbles(cuda)
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    assert not dispatch.screen_on_host(CPU)
    assert not dispatch.pack_skip_nibbles(CPU)


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
        return [
            p.result()
            for _t, p in dispatch.pipelined_screens(
                iter(tiles), lambda t: t, CPU, threshold_percent=8,
                compact_cap=compact_cap,
            )
        ]

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
    "branch, K", [("nibble", 8), ("many_alleles", 16), ("dense_switch", 8),
                  ("dense_switch", 16)],
)
def test_screen_tile_launch_matches_jax_in_each_branch(
    monkeypatch, branch, K, threshold_percent
):
    """The three branches of screen_tile_launch against the JAX
    screen_tile_launch (its nibble screen, or XLA's tile_stats for
    K > 15) and, for the dense switch, against the fused Pallas kernel
    interpreted: the port's one dense kernel serves both dense branches."""
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
        monkeypatch.setenv("GUAC_DENSE_TILES", "1")
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


def test_dense_switch_is_read_from_the_environment(monkeypatch):
    monkeypatch.delenv("GUAC_DENSE_TILES", raising=False)
    assert not dispatch.dense_tiles()
    monkeypatch.setenv("GUAC_DENSE_TILES", "0")
    assert not dispatch.dense_tiles()
    monkeypatch.setenv("GUAC_DENSE_TILES", "1")
    assert dispatch.dense_tiles()


def test_screen_packed_launch_matches_jax():
    aid, _q, _m, _s, valid, iv = dense_tile(5)
    packed = dispatch.pack_nibbles(aid, valid)
    want = jax_dispatch.screen_packed_launch(packed, iv, 8, 8).result()
    got = dispatch.screen_packed_launch(packed, iv, 8, 8, device=CPU).result()
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.candidates, np.asarray(want.candidates))


def _full_tiles(max_alleles=8):
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
        for tile in source.iter_tiles(
            "chr1", loci, fields="screen", max_alleles=max_alleles)
    ]


@pytest.mark.parametrize("host_screen", ["0", "1"])
@pytest.mark.parametrize("compact_cap", [None, 512])
def test_dense_switch_packs_full_tiles_and_screens_them(
    monkeypatch, compact_cap, host_screen
):
    """With GUAC_DENSE_TILES=1 iter_tiles packs fields='full' whatever the
    caller asked for, and pipelined_screens and screen_tile_for take the
    dense kernel (also where host screens are the default, as in the JAX
    package); the counts and flags are the default route's."""
    default = [
        dispatch.screen_tile_for(t, threshold_percent=8, device=CPU)
        for t in _tiles_both_packers()
    ]
    monkeypatch.setenv("GUAC_DENSE_TILES", "1")
    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    tiles = _full_tiles()
    assert all(t.allele_id is not None and t.csr_nib is None for t in tiles)
    screened = [
        p.result() for _t, p in dispatch.pipelined_screens(
            iter(tiles), lambda t: t, CPU, threshold_percent=8,
            compact_cap=compact_cap,
        )
    ]
    assert len(screened) == len(default)
    for tile, got, want in zip(tiles, screened, default):
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.candidates, want.candidates)
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
    piped = [
        p.result() for _t, p in dispatch.pipelined_screens(
            iter(tiles), lambda t: t, CPU, threshold_percent=8, compact_cap=512)
    ]
    assert all(isinstance(r, dispatch.ScreenResult) for r in piped)


def test_dense_route_refuses_a_reduced_tile(monkeypatch):
    tile = next(t for t in _tiles_both_packers() if t.allele_id is None)
    monkeypatch.setenv("GUAC_DENSE_TILES", "1")
    with pytest.raises(ValueError, match="fields='full'"):
        dispatch.screen_tile_for(tile, device=CPU)


@pytest.fixture(scope="module")
def scale_fixture(tmp_path_factory):
    from guacamole_tpu_torch.utils.simulate import make_scale_fixture

    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


@pytest.mark.parametrize(
    "caller", ["germline-threshold", "germline-standard", "somatic-standard"]
)
def test_dense_switch_gives_each_callers_default_vcf(
    monkeypatch, tmp_path, scale_fixture, caller
):
    """GUAC_DENSE_TILES=1 changes what is shipped and which kernel screens
    it, never the calls."""
    from guacamole_tpu_torch import cli as port_cli
    from guacamole_tpu_torch.concordance import compare_vcf_records

    args = {
        "germline-threshold": [
            "--reads", scale_fixture["germline_bam"], "--threshold", "25"],
        "germline-standard": [
            "--reads", scale_fixture["germline_bam"],
            "--loci", "deep1m:0-12000,shallow8m:0-60000"],
        "somatic-standard": [
            "--tumor-reads", scale_fixture["tumor_bam"],
            "--normal-reads", scale_fixture["normal_bam"], "--odds", "20",
            "--loci", "deep1m:0-12000"],
    }[caller]
    dense_launches = []
    real = dispatch.screen_dense_launch
    monkeypatch.setattr(
        dispatch, "screen_dense_launch",
        lambda *a, **k: dense_launches.append(1) or real(*a, **k),
    )

    def run(name):
        out = str(tmp_path / name)
        assert port_cli.main(
            [caller, *args, "--out", out, "--device", "cpu", "--debug"]) == 0
        return out

    default = run("default.vcf")
    assert not dense_launches
    monkeypatch.setenv("GUAC_DENSE_TILES", "1")
    dense = run("dense.vcf")
    assert dense_launches
    cmp = compare_vcf_records(dense, default)
    assert cmp.record_level_identical, (cmp.only_a[:5], cmp.only_b[:5])
    assert cmp.matching > 0
