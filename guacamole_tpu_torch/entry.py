"""Entry point of the port's forward step.

entry(): the single-device forward step of the JAX package's
__graft_entry__.entry(): allele counts, candidate flags and the diploid
genotype log-likelihoods of one dense tile, here in one pass of the fused
dense kernel (ops/kernels.py::tile_stats_ll: the stats_ll CUDA kernel on
the card, its plain version on the CPU). It runs on the card unless the
caller asks for the CPU.

The multi-device dry run of __graft_entry__ (dryrun_multichip) waits for
the port of parallel/mesh.py.
"""

from __future__ import annotations

import numpy as np

FORWARD_ALLELES = 8


def _example_tile(L=128, D=32, K=FORWARD_ALLELES, seed=0):
    """The example tile of __graft_entry__._example_tile: the same numpy
    calls on the same seed, so both packages step over equal arrays."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(1, D, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    allele_id = np.where(
        valid, rng.randint(0, 3, size=(L, D)).astype(np.int16), -1
    ).astype(np.int16)
    qual = np.where(valid, rng.randint(5, 40, size=(L, D)), 0).astype(np.int16)
    mapq = np.where(valid, rng.randint(10, 60, size=(L, D)), 0).astype(np.int16)
    strand = valid & (rng.rand(L, D) < 0.5)
    is_variant = np.zeros((L, K), dtype=bool)
    is_variant[:, 1:3] = True
    return allele_id, qual, mapq, strand, valid, is_variant


def entry(device=None):
    """Returns (forward, example_args). forward takes the six planes of a
    dense tile (numpy arrays, staged through dense_wire_from_numpy, or
    tensors already on the device) and returns (counts [L, K] int32,
    candidates [L] bool, log_likelihoods [L, P] f32) as tensors on the
    device. device: None or "cuda" for the card (fails without one), "cpu"
    on request."""
    import torch

    from guacamole_tpu_torch.ops.dispatch import dense_wire_from_numpy
    from guacamole_tpu_torch.ops.kernels import tile_stats_ll
    from guacamole_tpu_torch.platform import device as resolve_device

    dev = resolve_device(device)

    def forward(allele_id, qual, mapq, strand, valid, is_variant):
        planes = (allele_id, qual, mapq, strand, valid, is_variant)
        if not all(isinstance(p, torch.Tensor) for p in planes):
            planes = dense_wire_from_numpy(*planes, device=dev)[:6]
        out = tile_stats_ll(
            *planes, FORWARD_ALLELES, include_alignment=False,
            threshold_percent=None,
        )
        return out.counts, out.candidates, out.log_likelihoods

    return forward, _example_tile()
