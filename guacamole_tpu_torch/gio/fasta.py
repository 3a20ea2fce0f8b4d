"""FASTA reference genome reading.

The reference genome is loaded once per host and treated as replicated
host-side state (the TPU-native analog of the reference's per-executor
Spark broadcast, cf. reference .../ReferenceBroadcast.scala:39-56);
contig slices needed by jitted kernels are captured as device constants.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from guacamole_tpu_torch.utils import bases as Bases


class ContigNotFound(KeyError):
    def __init__(self, contig_name: str, available: Iterable[str]):
        super().__init__(
            f"Contig {contig_name} does not exist in the current reference. "
            f"Available contigs are {','.join(available)}"
        )
        self.contig_name = contig_name


class ReferenceGenome:
    """In-memory reference: contig name -> unmasked uppercase bases."""

    def __init__(self, contigs: Dict[str, bytes]):
        self.contigs = contigs

    @staticmethod
    def from_fasta(path: str) -> "ReferenceGenome":
        contigs: Dict[str, bytes] = {}
        name: Optional[str] = None
        parts = []
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if line.startswith(b">"):
                    if name is not None:
                        contigs[name] = Bases.unmask(b"".join(parts))
                    # Contig name is the first whitespace-delimited token.
                    name = line[1:].split()[0].decode("ascii")
                    parts = []
                elif line:
                    parts.append(line)
        if name is not None:
            contigs[name] = Bases.unmask(b"".join(parts))
        return ReferenceGenome(contigs)

    def get_contig(self, contig_name: str) -> bytes:
        try:
            return self.contigs[contig_name]
        except KeyError:
            raise ContigNotFound(contig_name, self.contigs.keys())

    def get_reference_base(self, contig_name: str, locus: int) -> int:
        return self.get_contig(contig_name)[locus]

    def get_reference_sequence(
        self, contig_name: str, start_locus: int, end_locus: int
    ) -> bytes:
        return self.get_contig(contig_name)[start_locus:end_locus]

    def build_md_tag(
        self, read_sequence: bytes, contig_name: str, reference_start: int, cigar
    ) -> str:
        from guacamole_tpu_torch.reads.mdtag import build_md_tag

        ref = self.get_reference_sequence(
            contig_name, reference_start, reference_start + cigar.reference_length
        )
        return build_md_tag(read_sequence, ref, cigar)

    @property
    def contig_lengths(self) -> Dict[str, int]:
        return {name: len(seq) for name, seq in self.contigs.items()}


def get_base_fraction(sequence: bytes) -> Dict[int, float]:
    """Per-base fraction of a sequence (cf. ReferenceUtils.scala:12-20)."""
    if not sequence:
        return {}
    arr = np.frombuffer(sequence, dtype=np.uint8)
    values, counts = np.unique(arr, return_counts=True)
    n = float(len(sequence))
    return {int(v): c / n for v, c in zip(values, counts)}


def get_gc_fraction(sequence: bytes) -> float:
    frac = get_base_fraction(sequence)
    return frac.get(Bases.G, 0.0) + frac.get(Bases.C, 0.0)


def get_at_fraction(sequence: bytes) -> float:
    frac = get_base_fraction(sequence)
    return frac.get(Bases.A, 0.0) + frac.get(Bases.T, 0.0)
