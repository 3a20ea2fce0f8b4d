from guacamole_tpu_torch.parallel.mesh import (
    loci_mesh,
    sharded_call_step,
    stack_tiles,
)
