"""The port's screen dispatch against the JAX dispatch on the same inputs.

Both run with GUAC_HOST_SCREEN=0, so the JAX side runs its XLA screens
and the port runs its kernels' plain twins (CPU tensors) through the whole
staging, slab and fetch path. Integer outputs: tolerance 0.
"""

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
