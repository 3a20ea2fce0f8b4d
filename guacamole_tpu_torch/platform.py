"""Device selection for the port (cf. guacamole_tpu/platform.py).

There is no global default device: the CLI asks device() once and passes
the result down explicitly. The host allocator tuning is shared with the
JAX package (guacamole_tpu.platform.tune_allocator, which is jax-free).
"""

from __future__ import annotations

import torch


def device() -> torch.device:
    """cuda when a CUDA device is present, else cpu."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
