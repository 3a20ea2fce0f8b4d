"""Multi-device execution of the port: a loci-sharded list of devices.

Port of guacamole_tpu/parallel/mesh.py. The distribution model is the JAX
package's, which replaces the reference's Spark shuffle
(cf. reference .../DistributedUtil.scala:558-634) with:

 - host-side loci partitioning (uniform or depth-balanced) assigning each
   device a contiguous span of loci tiles;
 - halo duplication on host: reads overlapping a shard boundary are packed
   into both shards (the reference's boundary-read duplication, :585-597),
   so per-locus compute is fully local to one device;
 - one screen per tile, each tile of a group on its own shard: its device
   and its own CUDA stream.

Where the JAX package runs one shard_map step per group over a 1-D "loci"
mesh, each shard here launches through the port's own dispatch
(screen_csr_launch, germline_screen_launch, tumor_screen_launch,
ops/kernels.py::tile_stats_ll) under its device and its stream: the slab
splitting, the pinned staging and the kernels are the sequential path's.
There is no padding to a bucketed [n, L, D] stack either: those bucketed
shapes only bounded XLA's set of compiled shapes, and each shard here
launches at its own tile's size. The psum'd counters of the sharded call
step become a sum over the shards' outputs.

A device may appear more than once: shards on one device then run on
separate streams of it. That is how the CPU tests ([cpu] * 4) and a
one-card machine ([cuda:0, cuda:0]) exercise groups of several shards,
the counterpart of the JAX tests' virtual CPU devices.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class LociMesh:
    """An ordered list of devices (one per shard) and one CUDA stream per
    shard on a card (None on the CPU)."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported mesh device {d}")
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devs
        )

    @property
    def size(self) -> int:
        return len(self.devices)

    @contextlib.contextmanager
    def on_shard(self, shard: int):
        """Make shard's device and stream current: the dispatch's copies,
        the kernel wrappers and the fetch events then all queue on that
        stream, and the kernels size themselves by that device."""
        stream = self.streams[shard]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[shard]), torch.cuda.stream(stream):
            yield

    def __repr__(self) -> str:
        return f"LociMesh({[str(d) for d in self.devices]})"


def loci_mesh(devices: Sequence = None) -> LociMesh:
    """A mesh over the given devices, or over every local CUDA device.
    Raises when no device is given and there is no CUDA device: a mesh
    never falls back to the CPU unasked."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available for the mesh; pass --device "
                "cpu (or CPU devices) to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    return LociMesh(devices)


# ---------------------------------------------------------------------------
# Production mesh screens: groups of mesh.size tiles, one tile per shard.
# ---------------------------------------------------------------------------


class _MeshPending:
    """One shard's launched screen, presenting the .result() protocol the
    callers' classify/confirm stages already consume: for the counting
    screen a ScreenResult of counts[:L] (int16) and candidates[:L], no
    compaction and no depth (the JAX mesh step's), for the likelihood
    screens the [L] candidate mask."""

    __slots__ = ("pending", "shard", "device", "_L")

    def __init__(self, pending, shard: int, device: torch.device, L: int):
        self.pending = pending
        self.shard = shard
        self.device = device
        self._L = L

    def result(self):
        from guacamole_tpu_torch.ops.dispatch import ScreenResult

        res = self.pending.result()
        if isinstance(res, np.ndarray):  # candidates-only (likelihood)
            return res[: self._L]
        return ScreenResult(
            counts=res.counts[: self._L], candidates=res.candidates[: self._L]
        )


def _dense_to_csr(tile) -> Tuple[np.ndarray, np.ndarray]:
    """CSR nibble encoding from a full tile's per-element tensors (the
    fallback when the packer didn't emit csr_nib — Python-packed tiles)."""
    allele_id = np.asarray(tile.allele_id)
    valid = np.asarray(tile.valid).astype(bool)
    L = allele_id.shape[0]
    # Compact valid slots to the front of each row (stable).
    order = np.argsort(~valid, axis=1, kind="stable")
    compact = np.take_along_axis(
        np.where(valid, allele_id & 0xF, 0xF).astype(np.uint8), order, axis=1
    )
    depths = valid.sum(axis=1)
    nbytes = (depths + 1) // 2
    row_off = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(nbytes, out=row_off[1:])
    blob = np.empty(int(row_off[-1]), dtype=np.uint8)
    for r in range(L):
        d = int(depths[r])
        if not d:
            continue
        row = compact[r, :d]
        if d % 2:
            row = np.concatenate([row, np.full(1, 0xF, np.uint8)])
        blob[row_off[r] : row_off[r + 1]] = row[0::2] | (row[1::2] << 4)
    return blob, row_off


def csr_of(tile) -> Tuple[np.ndarray, np.ndarray]:
    """A tile's CSR nibble encoding (native when present, else derived)."""
    if getattr(tile, "csr_nib", None) is not None:
        nib = np.asarray(tile.csr_nib)
        off = np.asarray(tile.csr_off, dtype=np.int32)
        # A skip_nibbles-packed tile (empty blob with nonzero offsets)
        # must never reach a device CSR launch — it would silently count
        # nothing. Callers pass skip_nibbles only on host-screen runs.
        # A hard raise (not assert): the failure mode is silently wrong
        # calls, which must fail under python -O too.
        if len(nib) == 0 and len(off) > 0 and off[-1] != 0:
            raise RuntimeError(
                "CSR tile was packed with skip_nibbles but reached a "
                "device screen launch"
            )
        return nib, off
    return _dense_to_csr(tile)


def _grouped(items, tile_of, n: int, launch, groups_in_flight: int):
    """The grouping contract of both mesh screens: groups of n non-empty
    tiles, launched when a group is full (the partial final group at the
    end, launching nothing for its absent shards); an empty tile yields
    (item, None) at once; at most groups_in_flight * n pendings held.
    launch(shard, tile) returns the shard's pending."""
    in_flight: deque = deque()
    group: List = []

    def flush():
        for s, item in enumerate(group):
            tile = tile_of(item)
            in_flight.append((item, launch(s, tile)))
        group.clear()

    for item in items:
        tile = tile_of(item)
        if not tile.L:
            in_flight.append((item, None))
        else:
            group.append(item)
            if len(group) == n:
                flush()
        while len(in_flight) > groups_in_flight * n:
            yield in_flight.popleft()
    if group:
        flush()
    while in_flight:
        yield in_flight.popleft()


def mesh_csr_screens(
    items,
    tile_of,
    mesh: LociMesh,
    threshold_percent=None,
    groups_in_flight: int = 2,
):
    """Screen a stream of CSR tiles over the mesh: group mesh.size tiles,
    launch each on its own shard (device and stream), yield (item,
    pending). The full-count screen with `threshold_percent` as given
    (None: no rule, as variant-support and vaf-histogram take it); no
    compaction.

    Partial final groups launch nothing for the absent shards. Yield order
    is per-group (an empty tile's item comes out ahead of a group still
    filling); callers sort at the end.
    """
    from guacamole_tpu_torch.ops.dispatch import screen_csr_launch

    def launch(s, tile):
        nib, off = csr_of(tile)
        device = mesh.devices[s]
        with mesh.on_shard(s):
            pending = screen_csr_launch(
                nib, off, np.asarray(tile.is_variant), tile.K,
                threshold_percent=threshold_percent, device=device,
            )
        return _MeshPending(pending, s, device, tile.L)

    return _grouped(items, tile_of, mesh.size, launch, groups_in_flight)


def mesh_ll_screens(
    items,
    tile_of,
    mesh: LociMesh,
    margin: float = 0.5,
    include_alignment: bool = False,
    min_mapq: int = 0,
    min_phred: float = 0.0,
    groups_in_flight: int = 2,
):
    """Screen a stream of likelihood-packed tiles over the mesh (germline
    form, or the tumor alignment-included form). Same grouping contract as
    mesh_csr_screens; yields (item, pending-candidates)."""
    from guacamole_tpu_torch.ops.dispatch import (
        germline_screen_launch,
        ll_mapq_of,
        ll_pack_of,
        ll_screen_arrays_launch,
        tumor_screen_launch,
    )

    def launch(s, tile):
        device = mesh.devices[s]
        with mesh.on_shard(s):
            if include_alignment and getattr(tile, "ll_mapq", None) is None:
                # A Python-packed full tile: its uint16 form and MAPQ plane
                # come from the per-element tensors, as the JAX mesh step
                # packs them.
                pending = ll_screen_arrays_launch(
                    ll_pack_of(tile, min_mapq), ll_mapq_of(tile, min_mapq),
                    tile.is_variant, tile.is_standard_alt, tile.K,
                    margin=margin, device=device,
                )
            elif include_alignment:
                pending = tumor_screen_launch(
                    tile, min_mapq=min_mapq, margin=margin, device=device
                )
            else:
                pending = germline_screen_launch(
                    tile, min_mapq=min_mapq, margin=margin,
                    min_phred=min_phred, device=device,
                )
        return _MeshPending(pending, s, device, tile.L)

    return _grouped(items, tile_of, mesh.size, launch, groups_in_flight)


# ---------------------------------------------------------------------------
# Full sharded calling step (counts + likelihoods + summed counters): used
# by dryrun_multichip and the mesh tests. Each shard runs the fused dense
# kernel (tile_stats_ll) on its device, the counterpart of the JAX step's
# tile_stats + probability_correct + genotype_log_likelihoods.
# ---------------------------------------------------------------------------


class ShardedBatch(NamedTuple):
    """Per-shard stacked tile planes: leading axis = shard."""

    allele_id: torch.Tensor  # [S, L, D] int16
    qual: torch.Tensor  # [S, L, D] int16
    mapq: torch.Tensor  # [S, L, D] int16
    strand: torch.Tensor  # [S, L, D] bool
    valid: torch.Tensor  # [S, L, D] bool
    is_variant: torch.Tensor  # [S, L, K] bool


def stack_tiles(tiles: Sequence) -> ShardedBatch:
    """Stack same-shape tiles into [S, L, D] host tensors (one per shard)."""
    return ShardedBatch(
        *(
            torch.from_numpy(
                np.stack([np.asarray(getattr(t, field)) for t in tiles])
            )
            for field in ShardedBatch._fields
        )
    )


class CallStepOutput(NamedTuple):
    counts: torch.Tensor  # [S, L, K] int32 per-locus allele counts
    forward_counts: torch.Tensor  # [S, L, K] int32
    depth: torch.Tensor  # [S, L] int32
    candidates: torch.Tensor  # [S, L] bool: variant evidence present
    log_likelihoods: torch.Tensor  # [S, L, P] f32 genotype log-likelihoods
    total_elements: torch.Tensor  # [] int64 element count, summed over shards
    total_candidates: torch.Tensor  # [] int64 candidate-locus count


def make_sharded_call_step(
    mesh: LociMesh, max_alleles: int, threshold_percent=None
):
    """The per-shard calling step over the mesh: step(batch) ->
    CallStepOutput, with every output on the host.

    Each shard stages its own [L, D] tile onto its device (on its stream)
    and runs the fused dense kernel there (counts, forward counts, depth,
    the candidate rule and the diploid genotype log-likelihoods); all
    shards launch before any result is fetched. The global counters are
    the sums over the shards' outputs (the JAX step's psum)."""
    from guacamole_tpu_torch.ops.dispatch import dense_wire_from_numpy
    from guacamole_tpu_torch.ops.kernels import tile_stats_ll

    def step(batch: ShardedBatch) -> CallStepOutput:
        n = len(batch.allele_id)
        if n != mesh.size:
            raise ValueError(
                f"need {mesh.size} tiles (one per shard), got {n}"
            )
        launched = []  # (wire, output): the staged buffers stay alive
        for s in range(n):
            planes = [np.asarray(p[s]) for p in batch]
            with mesh.on_shard(s):
                wire = dense_wire_from_numpy(*planes, device=mesh.devices[s])
                launched.append((wire, tile_stats_ll(
                    *wire[:6], max_alleles, include_alignment=False,
                    threshold_percent=threshold_percent,
                )))
        fetched = []
        for s, (_wire, out) in enumerate(launched):
            with mesh.on_shard(s):  # the copy waits on the shard's stream
                fetched.append([t.cpu() for t in out])
        counts, fwd, depth, cand, ll = (
            torch.stack(field) for field in zip(*fetched)
        )
        return CallStepOutput(
            counts, fwd, depth, cand, ll,
            depth.sum(dtype=torch.int64),
            cand.sum(dtype=torch.int64),
        )

    return step


def sharded_call_step(
    tiles: Sequence, mesh: Optional[LociMesh] = None, max_alleles: int = 8
) -> CallStepOutput:
    """Convenience: stack tiles (one per shard) and run the sharded step."""
    if mesh is None:
        mesh = loci_mesh()
    return make_sharded_call_step(mesh, max_alleles)(stack_tiles(tiles))
