"""Mesh-distributed calling: the port's multi-device execution path.

Port of guacamole_tpu/callers/distributed.py. Each caller's device screen
runs in groups of mesh.size tiles, each tile on its own shard (device and
CUDA stream), replacing the reference's Spark task scheduling
(cf. reference .../DistributedUtil.scala:288-364: the pileupFlatMap family
serving every caller through one distributed engine). Host-side
classification / exact-f64 confirmation is unchanged, so mesh output is
identical to the sequential path by construction (and by
tests/test_torch_mesh.py).

These wrappers delegate to the callers' own `mesh=` parameter — the mesh
path lives inside each caller (wired from the CLI via --mesh), not in a
separate engine; this module is the stable API for tests and tools. The
mesh defaults to every local CUDA device; `device`, where a caller still
needs one outside the screens, to the mesh's first.
"""

from __future__ import annotations

from typing import List

from guacamole_tpu_torch.callers import germline_standard, germline_threshold
from guacamole_tpu_torch.callers import somatic_standard
from guacamole_tpu_torch.callers.germline_threshold import ThresholdCall
from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.parallel.mesh import loci_mesh


def _mesh_and_device(mesh, device):
    mesh = mesh if mesh is not None else loci_mesh()
    return mesh, device if device is not None else mesh.devices[0]


def call_variants_mesh(
    reads,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    device=None,
) -> List[ThresholdCall]:
    """germline-threshold over a device mesh (one tile per shard)."""
    mesh, device = _mesh_and_device(mesh, device)
    return germline_threshold.call_variants(
        reads,
        loci_partitions,
        threshold_percent=threshold_percent,
        emit_ref=emit_ref,
        emit_no_call=emit_no_call,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh,
        device=device,
    )


def call_standard_mesh(
    reads,
    loci_partitions: LociMap,
    min_alignment_quality: int = 0,
    emit_ref: bool = False,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    device=None,
):
    """germline-standard over a device mesh: the f32 genotype-likelihood
    screen runs one tile per shard; exact f64 confirm on host."""
    mesh, device = _mesh_and_device(mesh, device)
    return germline_standard.call_variants(
        reads,
        loci_partitions,
        min_alignment_quality=min_alignment_quality,
        emit_ref=emit_ref,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh,
        device=device,
    )


def call_somatic_mesh(
    tumor_reads,
    normal_reads,
    loci_partitions: LociMap,
    odds_threshold: int = 20,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = 2**31 - 1,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    device=None,
):
    """somatic-standard over a device mesh: the alignment-included tumor
    screen runs one tile per shard (tumor/normal stay a host-side pair —
    the exact confirm packs both samples' sparse tiles, the analog of the
    two-sample tile axis in DistributedUtil.scala:316-364)."""
    mesh, device = _mesh_and_device(mesh, device)
    return somatic_standard.call_variants(
        tumor_reads,
        normal_reads,
        loci_partitions,
        odds_threshold=odds_threshold,
        min_alignment_quality=min_alignment_quality,
        filter_multi_allelic=filter_multi_allelic,
        max_read_depth=max_read_depth,
        tile_size=tile_size,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
        mesh=mesh,
        device=device,
    )
