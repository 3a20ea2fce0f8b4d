"""Screen tiles from a shared guacamole_tpu ReadSource.

Port of guacamole_tpu/callers/source.py:109-163 for fields="screen". The
JAX ReadSource.iter_tiles imports guacamole_tpu.ops.dispatch (and with it
jax) to ask whether the fused dense Pallas kernel wants full tiles; the
port has no such kernel, so it packs screen tiles directly. The
ReadSource itself (from callers/common.load_read_source or
callers/streaming.iter_task_sources) is shared, not copied.
"""

from __future__ import annotations

from typing import Iterator


def iter_screen_tiles(
    source,
    contig: str,
    loci,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    skip_nibbles: bool = False,
) -> Iterator:
    """Yield the CSR screen tiles of `loci` on `contig`, one at a time, so
    the caller can screen tile i while tile i+1 packs: columnar sources
    through the native packer (CSR blob + counts), object sources through
    the Python packer (dense tiles; the dispatch reads their nibble rows
    as CSR rows)."""
    if source.is_columnar:
        from guacamole_tpu.pack.columnar import iter_tiles_columnar

        yield from iter_tiles_columnar(
            source._cols,  # the columnar reads; ReadSource has no accessor
            contig,
            loci,
            tile_size=tile_size,
            max_alleles=max_alleles,
            reference_genome=reference_genome,
            fields="screen",
            skip_nibbles=skip_nibbles,
        )
        return
    from guacamole_tpu.pack.tiles import pack_tiles

    yield from pack_tiles(
        source.reads_list(),
        contig,
        loci,
        tile_size=tile_size or 4096,
        max_alleles=max_alleles,
        reference_genome=reference_genome,
    )
