"""Genotype concordance vs a truth set.

(cf. reference .../Concordance.scala:40-130: printGenotypeConcordance
computes precision/recall/F1 of called genotypes against a truth VCF.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, Set, Tuple

from guacamole_tpu_torch.gio.vcf import SimpleVariant, VcfRecord, read_vcf

Site = Tuple[str, int, str, str]  # (contig, start0, ref, alt)


@dataclass(frozen=True)
class ConcordanceResult:
    true_positives: int
    false_positives: int
    false_negatives: int

    @property
    def precision(self) -> float:
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom else 0.0

    @property
    def f1_score(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0


def _is_snv(ref: str, alt: str) -> bool:
    return len(ref) == 1 and len(alt) == 1 and ref != alt


def _is_indel(ref: str, alt: str) -> bool:
    return len(ref) != len(alt)


def _site_passes(
    site: Site, exclude_snvs: bool, exclude_indels: bool, chromosome: str
) -> bool:
    """The reference's relevantVariants predicate (Concordance.scala:77-83):
    keep a variant iff it is on the requested chromosome (if any) AND is
    either a non-excluded SNV or a non-excluded insertion/deletion. Variants
    that are neither (MNVs/complex) are always dropped, as there."""
    contig, _, ref, alt = site
    if chromosome and contig != chromosome:
        return False
    return (not exclude_snvs and _is_snv(ref, alt)) or (
        not exclude_indels and _is_indel(ref, alt)
    )


def _call_sites(records: Iterable[VcfRecord]) -> Set[Site]:
    return {(r.contig, r.start, r.ref, r.alt) for r in records}


def _truth_sites(variants: Iterable[SimpleVariant]) -> Set[Site]:
    return {
        (v.contig, v.start, v.ref, alt) for v in variants for alt in v.alts
    }


def compute_concordance(
    calls: Sequence[VcfRecord],
    truth_vcf_path: str,
    exclude_snvs: bool = False,
    exclude_indels: bool = False,
    chromosome: str = "",
) -> ConcordanceResult:
    """Exact-site (contig, position, ref, alt) concordance, with the
    reference's SNV/indel/chromosome pre-filters applied to both the calls
    and the truth set (Concordance.scala:72-90)."""

    def keep(s: Site) -> bool:
        return _site_passes(s, exclude_snvs, exclude_indels, chromosome)

    called = {s for s in _call_sites(calls) if keep(s)}
    truth = {s for s in _truth_sites(read_vcf(truth_vcf_path)) if keep(s)}
    tp = len(called & truth)
    return ConcordanceResult(
        true_positives=tp,
        false_positives=len(called) - tp,
        false_negatives=len(truth) - tp,
    )


def print_genotype_concordance(
    calls: Sequence[VcfRecord],
    truth_vcf_path: str,
    exclude_snvs: bool = False,
    exclude_indels: bool = False,
    chromosome: str = "",
) -> ConcordanceResult:
    """Print precision/recall/F1 in the reference's tab-separated format
    (Concordance.scala:124-129). The reference's destructuring there swaps
    the first two values returned by computePrecisionAndRecall (which
    returns (recall, precision, f1)); we print each metric under its
    correct header — see DEVIATIONS.md."""
    result = compute_concordance(
        calls,
        truth_vcf_path,
        exclude_snvs=exclude_snvs,
        exclude_indels=exclude_indels,
        chromosome=chromosome,
    )
    print("Precision\tRecall\tF1Score")
    print("%f\t%f\t%f" % (result.precision, result.recall, result.f1_score))
    return result


# ---------------------------------------------------------------------------
# Record-level VCF comparison: the precise parity contract
# (CHROM, POS, REF, ALT, normalized GT) between two VCF files — the
# comparator to run against a reference-generated VCF (e.g. the manual
# chrM run of reference README.md:44-49) the day one is obtainable;
# container headers are deliberately out of scope (DEVIATIONS.md #4).
# ---------------------------------------------------------------------------

# One VCF data line's comparable content.
VcfKey = Tuple[str, int, str, str, str]


def _normalize_gt(gt: str) -> str:
    """Allele-order-insensitive genotype: '1/0' == '0/1'; phase ignored
    (the callers emit unphased diploid genotypes)."""
    alleles = gt.replace("|", "/").split("/")
    return "/".join(sorted(alleles))


def _record_keys(path: str) -> Set[VcfKey]:
    keys: Set[VcfKey] = set()
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, _id, ref, alt = fields[:5]
            gt = ""
            if len(fields) >= 10:
                fmt = fields[8].split(":")
                sample = fields[9].split(":")
                if "GT" in fmt:
                    gt = _normalize_gt(sample[fmt.index("GT")])
            keys.add((chrom, int(pos), ref, alt, gt))
    return keys


@dataclass(frozen=True)
class VcfComparison:
    matching: int
    only_a: Tuple[VcfKey, ...]
    only_b: Tuple[VcfKey, ...]

    @property
    def record_level_identical(self) -> bool:
        return not self.only_a and not self.only_b


def compare_vcf_records(path_a: str, path_b: str) -> VcfComparison:
    """Record-level diff of two VCF files on (CHROM, POS, REF, ALT, GT),
    GT normalized to be allele-order/phase-insensitive. Headers and all
    other per-record fields (QUAL, INFO, depths) are out of scope — this
    checks the call-set contract, nothing weaker, nothing stronger."""
    a = _record_keys(path_a)
    b = _record_keys(path_b)
    return VcfComparison(
        matching=len(a & b),
        only_a=tuple(sorted(a - b)),
        only_b=tuple(sorted(b - a)),
    )
