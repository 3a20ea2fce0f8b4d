"""ReadSet: a loaded collection of reads plus sequence-dictionary metadata.

(cf. reference .../ReadSet.scala:96-125; the RDD becomes a host list /
columnar arrays feeding the tile packer.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from guacamole_tpu_torch.reads.read import (
    InputFilters,
    MappedRead,
    PairedMappedRead,
    PairedRead,
)


@dataclass
class ReadSet:
    reads: List[object]
    sequence_dictionary: Optional[Dict[str, int]]
    source: str
    filters: InputFilters
    token: int
    contig_lengths_from_dictionary: bool

    @property
    def mapped_reads(self) -> List[MappedRead]:
        out = []
        for read in self.reads:
            if isinstance(read, MappedRead):
                out.append(read)
            elif isinstance(read, PairedRead) and isinstance(read.read, MappedRead):
                out.append(read.read)
        return out

    @property
    def mapped_paired_reads(self) -> List[PairedRead]:
        return [
            read
            for read in self.reads
            if isinstance(read, PairedRead) and read.is_mapped
        ]

    @property
    def contig_lengths(self) -> Dict[str, int]:
        """Contig lengths from the sequence dictionary, or inferred as the
        max read end per contig (cf. ReadSet.scala:69-81)."""
        if self.contig_lengths_from_dictionary:
            assert self.sequence_dictionary is not None
            return dict(self.sequence_dictionary)
        lengths: Dict[str, int] = {}
        for read in self.mapped_reads:
            contig = read.reference_contig
            lengths[contig] = max(lengths.get(contig, 0), read.end)
        return lengths
