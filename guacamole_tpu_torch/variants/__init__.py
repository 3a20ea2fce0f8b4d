from guacamole_tpu_torch.variants.allele import Allele, Genotype
from guacamole_tpu_torch.variants.called import CalledAllele, CalledSomaticAllele
from guacamole_tpu_torch.variants.evidence import AlleleEvidence
