from guacamole_tpu_torch.pileup.element import (
    Alignment,
    AlignmentKind,
    PileupElement,
)
from guacamole_tpu_torch.pileup.pileup import Pileup
