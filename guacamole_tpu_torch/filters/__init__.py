from guacamole_tpu_torch.filters.fishers import fishers_exact_test
from guacamole_tpu_torch.filters.genotype_filters import apply_genotype_filters
from guacamole_tpu_torch.filters.pileup_filters import (
    edge_base_filter,
    filter_pileup,
    multi_allelic_filter,
    quality_aligned_reads_filter,
)
from guacamole_tpu_torch.filters.somatic_filters import apply_somatic_filters
