"""Called variant records: germline and somatic.

(cf. reference .../variants/CalledAllele.scala, CalledSomaticAllele.scala)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from guacamole_tpu_torch.utils.phred import success_probability_to_phred
from guacamole_tpu_torch.variants.allele import Allele
from guacamole_tpu_torch.variants.evidence import AlleleEvidence


@dataclass(frozen=True)
class CalledAllele:
    """A germline variant call with supporting statistics."""

    sample_name: str
    reference_contig: str
    start: int  # 0-based
    allele: Allele
    evidence: AlleleEvidence
    rs_id: Optional[int] = None
    length: int = 1

    @property
    def end(self) -> int:
        return self.start + 1


@dataclass(frozen=True)
class CalledSomaticAllele:
    """A variant present in the tumor but not the normal sample."""

    sample_name: str
    reference_contig: str
    start: int  # 0-based
    allele: Allele
    somatic_log_odds: float
    tumor_variant_evidence: AlleleEvidence
    normal_reference_evidence: AlleleEvidence
    rs_id: Optional[int] = None
    length: int = 1

    @property
    def end(self) -> int:
        return self.start + 1

    @property
    def phred_scaled_somatic_likelihood(self) -> int:
        # P(variant in tumor AND no variant in normal)
        return success_probability_to_phred(
            self.tumor_variant_evidence.likelihood
            * self.normal_reference_evidence.likelihood
            - 1e-10
        )

    def with_rs_id(self, rs_id: Optional[int]) -> "CalledSomaticAllele":
        return replace(self, rs_id=rs_id)
