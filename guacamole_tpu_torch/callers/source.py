"""ReadSource: uniform access to reads for the callers (the port's copy of
guacamole_tpu/callers/source.py; iter_tiles packs the fields it is asked
for, where the original packs full tiles whenever use_pallas() holds).

The production path keeps reads columnar (native-decoded numpy arrays); the
object path (list of MappedReads) remains for SAM inputs and tests. Callers
are written against this interface:

  - pack_tiles(contig, loci): dense tile tensors for the device kernels
  - read(i): materialize read i (tile.read_index points here)
  - pileup_at(contig, locus): exact host pileup (overflow fallback)
  - by_sample(): per-sample sources
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.reads.read import MappedRead


class ReadSource:
    def __init__(self, reads=None, cols=None):
        assert (reads is None) != (cols is None)
        self._cols = cols
        if reads is not None:
            self._reads = sorted(reads, key=lambda r: (r.reference_contig, r.start))
        else:
            self._reads = None
        self._read_cache: Dict[int, MappedRead] = {}

    @staticmethod
    def from_reads(reads: Sequence[MappedRead]) -> "ReadSource":
        return ReadSource(reads=reads)

    @staticmethod
    def from_columnar(cols) -> "ReadSource":
        return ReadSource(cols=cols)

    @property
    def is_columnar(self) -> bool:
        return self._cols is not None

    @property
    def n(self) -> int:
        return self._cols.n if self._cols is not None else len(self._reads)

    def read(self, i: int) -> MappedRead:
        if self._reads is not None:
            return self._reads[i]
        cached = self._read_cache.get(i)
        if cached is None:
            cached = self._cols.to_mapped_read(i)
            self._read_cache[i] = cached
        return cached

    def reads_list(self) -> List[MappedRead]:
        """All reads as objects (object path only; avoid on columnar)."""
        if self._reads is not None:
            return self._reads
        return [self.read(i) for i in range(self._cols.n)]

    # --- sample handling ---

    def sample_names(self) -> List[str]:
        if self._cols is not None:
            present = np.unique(self._cols.sample_id)
            return sorted(self._cols.samples[int(s)] for s in present)
        return sorted({r.sample_name or "default" for r in self._reads})

    def for_sample(self, sample_name: str) -> "ReadSource":
        if self._cols is not None:
            sid = self._cols.samples.index(sample_name)
            mask = self._cols.sample_id == sid
            if mask.all():
                return self  # single-sample input: no copy
            return ReadSource(cols=self._cols.select(mask))
        return ReadSource(
            reads=[
                r
                for r in self._reads
                if (r.sample_name or "default") == sample_name
            ]
        )

    # --- packing ---

    def pack_tiles(
        self,
        contig: str,
        loci,
        tile_size: int = 4096,
        max_alleles: int = 8,
        reference_genome=None,
        fields: str = "full",
    ):
        return list(
            self.iter_tiles(
                contig,
                loci,
                tile_size=tile_size,
                max_alleles=max_alleles,
                reference_genome=reference_genome,
                fields=fields,
            )
        )

    def iter_tiles(
        self,
        contig: str,
        loci,
        tile_size: int = 0,
        max_alleles: int = 8,
        reference_genome=None,
        fields: str = "full",
        min_mapq: int = 0,
        ll_screen_margin: float = 0.0,
        ll_screen_kind: int = 1,
        skip_nibbles: bool = False,
        ll_screen_min_phred: float = 0.0,
    ) -> Iterator:
        """Yield tiles one at a time so callers can overlap device kernels
        on tile i with host packing of tile i+1.

        fields="screen" skips the per-element [L, D] tensors on the native
        packer path (only counts/allele tables/packed nibbles are built) —
        for callers that never touch per-element fields."""
        if self._cols is not None:
            from guacamole_tpu_torch.pack.columnar import iter_tiles_columnar

            yield from iter_tiles_columnar(
                self._cols,
                contig,
                loci,
                tile_size=tile_size,
                max_alleles=max_alleles,
                reference_genome=reference_genome,
                fields=fields,
                min_mapq=min_mapq,
                ll_screen_margin=ll_screen_margin,
                ll_screen_kind=ll_screen_kind,
                skip_nibbles=skip_nibbles,
                ll_screen_min_phred=ll_screen_min_phred,
            )
            return
        from guacamole_tpu_torch.pack.tiles import pack_tiles

        yield from pack_tiles(
            self._reads,
            contig,
            loci,
            tile_size=tile_size or 4096,
            max_alleles=max_alleles,
            reference_genome=reference_genome,
        )

    def pack_sparse_tile(
        self,
        contig: str,
        loci: Sequence[int],
        max_alleles: int = 8,
        reference_genome=None,
    ):
        """Pack ONE tile over an explicit (possibly sparse) loci list,
        keeping every requested locus."""
        if self._cols is not None:
            from guacamole_tpu_torch.pack.columnar import pack_tile_columnar
            from guacamole_tpu_torch.pack.fast import _empty_tile

            try:
                contig_id = self._cols.ref_names.index(contig)
            except ValueError:
                return _empty_tile(
                    contig,
                    np.asarray(sorted(loci), dtype=np.int64),
                    max_alleles,
                    8,
                )
            return pack_tile_columnar(
                self._cols,
                contig_id,
                contig,
                sorted(loci),
                max_alleles=max_alleles,
                reference_genome=reference_genome,
            )
        from guacamole_tpu_torch.pack.fast import pack_tile_fast

        contig_positions = [
            i
            for i, r in enumerate(self._reads)
            if r.reference_contig == contig
        ]
        tile = pack_tile_fast(
            [self._reads[i] for i in contig_positions],
            contig,
            sorted(loci),
            max_alleles=max_alleles,
            reference_genome=reference_genome,
        )
        # pack_tile_fast's read_index is relative to the list it was given;
        # remap to this source's read() indices (full-list positions).
        if tile.read_index is not None and len(contig_positions) != len(
            self._reads
        ):
            full = np.asarray(contig_positions, dtype=np.int32)
            ri = np.asarray(tile.read_index)
            mapped = np.full_like(ri, -1)
            mask = ri >= 0
            mapped[mask] = full[ri[mask]]
            tile.read_index = mapped
        return tile

    # --- exact host fallback ---

    def pileup_at(
        self, contig: str, locus: int, reference_base: Optional[int] = None
    ) -> Pileup:
        if self._cols is not None:
            contig_id = self._cols.ref_names.index(contig)
            mask = (
                (self._cols.ref_id == contig_id)
                & (self._cols.start <= locus)
                & (self._cols.end > locus)
            )
            reads = [self.read(int(i)) for i in np.flatnonzero(mask)]
        else:
            reads = [
                r
                for r in self._reads
                if r.reference_contig == contig and r.overlaps_locus(locus)
            ]
        return Pileup.from_reads(reads, contig, locus, reference_base)

    def pileup_from_tile_row(self, tile, li: int) -> Pileup:
        """Rebuild the exact pileup at a tile row from packed read indices."""
        from guacamole_tpu_torch.pileup.element import PileupElement

        locus = int(tile.loci[li])
        ref_base = int(tile.ref_base[li])
        elements = [
            PileupElement.at_locus(self.read(int(ri)), locus, ref_base)
            for ri, ok in zip(tile.read_index[li], tile.valid[li])
            if ok and ri >= 0
        ]
        return Pileup(tile.contig, locus, ref_base, elements)
