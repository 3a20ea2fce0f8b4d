from guacamole_tpu_torch.reads.cigar import Cigar, CigarElement
from guacamole_tpu_torch.reads.mdtag import MdTag
from guacamole_tpu_torch.reads.read import (
    InputFilters,
    MappedRead,
    MateAlignmentProperties,
    PairedMappedRead,
    PairedRead,
    UnmappedRead,
    make_read,
)
