from guacamole_tpu_torch.loci.locimap import LociMap, LociMapBuilder
from guacamole_tpu_torch.loci.lociset import LociSet, LociSetBuilder, parse_loci
from guacamole_tpu_torch.loci.partition import (
    partition_loci_by_approximate_depth,
    partition_loci_uniformly,
)
