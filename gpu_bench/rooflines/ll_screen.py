"""Roofline of the likelihood screen (ops/csrc/ll_screen.cu, ll_screen_kernel,
germline and tumor forms): one launch per slab that the dispatch stages
through ll_wire_from_numpy(ll_pack, ll_mapq, is_variant, is_standard_alt,
ll_qvals, device).

Only a row with a standard variant allele (among the 15 the flag word
holds) can be a candidate; the others need their flag word read and their
flag written, nothing more. Bytes: the valid elements of those rows (their
pack byte or word, and their MAPQ byte in the tumor form), every row's flag
word (4 B) and flag (1 B). Operations: two f32 adds per valid element of a
row that is read. Frozen from chip_smoke.py's count, with valid elements
in place of the [rows, D] slots of the rows read.
"""

import numpy as np

KERNEL = "ll_screen"
DEVICE_NAME = "ll_screen_kernel"
WRAPS = "guacamole_tpu_torch.ops.dispatch:ll_wire_from_numpy"


def work(args, kwargs):
    """(bytes, operations) that one launch's data needs."""
    names = ("ll_pack", "ll_mapq", "is_variant", "is_standard_alt",
             "ll_qvals")
    a = dict(zip(names, args))
    a.update({k: v for k, v in kwargs.items() if k in names})
    pack = np.asarray(a["ll_pack"])
    rows = pack.shape[0]
    iv = np.asarray(a["is_variant"], dtype=bool)[:, :15]
    std = np.asarray(a["is_standard_alt"], dtype=bool)[:, :15]
    live = (iv & std).any(axis=1)
    empty = 0xFF if pack.dtype == np.uint8 else 0xFFFF
    valid = int(np.count_nonzero(pack[live] != empty))
    per_element = pack.dtype.itemsize + (0 if a["ll_mapq"] is None else 1)
    return valid * per_element + rows * 5, 2 * valid
