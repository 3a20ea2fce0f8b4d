"""guacamole_tpu_torch: the PyTorch/CUDA port of guacamole_tpu.

The JAX package guacamole_tpu stays the reference. This package re-hosts
its device layer on PyTorch, with the TPU's Pallas kernels rewritten by
hand in CUDA C++ for Hopper (sm_90a), and shares every host layer that
does not import jax (BAM decoding, loci, the native packer, VCF output)
with guacamole_tpu instead of copying it. It never imports jax.

Ported so far: the germline-threshold caller end to end (streaming BAM
decode, depth-balanced partitions, the native CSR pack, the CSR counting
screen and its candidate compaction as CUDA kernels, host
classification, VCF output) and the `index` command.
"""

__version__ = "0.1.0"
