from guacamole_tpu_torch.alignment.affine_gap import (
    AlignmentState,
    ReadAlignment,
    align,
)
