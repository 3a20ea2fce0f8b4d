"""Roofline of the counting screen (ops/csrc/csr_screen.cu,
csr_count_screen_kernel): one launch per CSR slab that the dispatch stages
through wire_from_numpy(csr_nib, row_off, is_variant, device).

Bytes: the live blob (row_off[L] bytes of nibbles; the 0xFF padding after
it is not needed), the row offsets and variant words (L + 1 int32, L
uint16), and the outputs, counts (L x K int16, K the allele planes it is
handed) and flags (L bytes). Operations: one add per nibble, two per
byte. Frozen from chip_smoke.py's count, with the live blob in place of
the padded one.
"""

import numpy as np

KERNEL = "csr_count_screen"
DEVICE_NAME = "csr_count_screen_kernel"
WRAPS = "guacamole_tpu_torch.ops.dispatch:wire_from_numpy"


def work(args, kwargs):
    """(bytes, operations) that one launch's data needs."""
    names = ("csr_nib", "row_off", "is_variant")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    row_off = np.asarray(a["row_off"])
    rows = len(row_off) - 1
    k = np.asarray(a["is_variant"]).shape[1]
    live = int(row_off[-1]) if rows >= 0 else 0
    n_bytes = live + (rows + 1) * 4 + rows * 2 + rows * k * 2 + rows
    return n_bytes, 2 * live
