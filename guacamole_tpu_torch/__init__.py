"""guacamole_tpu_torch: the PyTorch/CUDA port of guacamole_tpu.

The JAX package guacamole_tpu stays the reference. This package re-hosts
its device layer on PyTorch, with the TPU's Pallas kernels rewritten by
hand in CUDA C++ for Hopper (sm_90a). It stands alone: it imports torch,
never jax, and nothing of guacamole_tpu. Every host layer it needs (BAM
decoding, loci, the packers and the native runtime's bindings, the exact
f64 likelihood, filters, VCF output) is its own copy, under the same
module names, and it builds its own copy of the C++ host runtime
(runtime/csrc/) into its own _build/ directory.
Its entry points run on the GPU unless the caller asks for the CPU.

Ported so far: the germline-threshold caller (the CSR counting screen and
its candidate compaction as CUDA kernels), the germline-standard caller
(the genotype-likelihood screen as a CUDA kernel, the exact f64 confirm on
the host), each end to end with streaming BAM decode, depth-balanced
partitions and the native pack, and the `index` command.
"""

__version__ = "0.1.0"
