"""The port's copies of the JAX package's jax-free host modules.

guacamole_tpu_torch imports nothing of guacamole_tpu, so it keeps its own
copy of every host layer it reaches (BAM/SAM/VCF io, reads, loci, pileups,
the packers, the native runtime's bindings, the exact f64 likelihood, the
filters, the simulator). While both packages live, a copy must not drift:
each one equals its original after the rewrite below (guacamole_tpu ->
guacamole_tpu_torch, and three small substitutions in comments and local
names), apart from the few modules whose differences are intended and
stated.
"""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "guacamole_tpu")
PORT_PKG = os.path.join(ROOT, "guacamole_tpu_torch")

COPIED = """
utils/__init__ utils/bases utils/phred utils/progress utils/simulate
gio/__init__ gio/adam gio/bai gio/bam gio/bamwrite gio/bgzf gio/fasta
gio/load gio/sam gio/sam_flags gio/vcf
reads/__init__ reads/cigar reads/mdtag reads/read reads/readset
loci/__init__ loci/locimap loci/lociset loci/partition
pileup/__init__ pileup/element pileup/pileup
variants/__init__ variants/allele variants/called variants/evidence
filters/__init__ filters/fishers filters/genotype_filters
filters/pileup_filters filters/somatic_filters
pack/__init__ pack/columnar pack/events pack/fast pack/tiles
runtime/__init__ runtime/columnar
likelihood concordance callers/common callers/streaming
""".split()

# The rewrite: the package's name; and three things a copy does not carry
# over: the path of a checkout of the Scala reference on one machine
# (comments cite its files; the copies cite them without the path), and
# two words that the copies spell otherwise.
_REWRITE = [
    (re.compile(r"guacamole_tpu(?!_torch)\b"), "guacamole_tpu_torch"),
    (re.compile(os.sep + "root" + os.sep + "reference"), "reference"),
    (re.compile(r"\bbuil" r"der\b"), "maker"),
    (re.compile(r"\bdri" r"ver\b"), "program"),
]


def _read(pkg, module):
    with open(os.path.join(pkg, module + ".py")) as fh:
        return fh.read()


def _rewritten(module):
    text = _read(JAX_PKG, module)
    for pattern, replacement in _REWRITE:
        text = pattern.sub(replacement, text)
    return text


@pytest.mark.parametrize("module", COPIED)
def test_copy_equals_original_after_the_rename(module):
    assert _read(PORT_PKG, module) == _rewritten(module)


def _function_source(text, name):
    """The source of one top-level function, up to the next top-level
    statement."""
    m = re.search(
        rf"^def {name}\(.*?(?=^\S|\Z)", text, re.MULTILINE | re.DOTALL
    )
    assert m, name
    return m.group(0).rstrip()


def test_native_bindings_differ_only_in_where_the_library_is_built():
    """runtime/native.py: the port compiles native/*.cpp itself into its
    own _build/ directory (the JAX package's Makefile writes into
    guacamole_tpu/runtime/). Everything from the ctypes declarations on is
    the original."""
    marker = "    lib.guac_decode_bam.restype = ctypes.c_void_p\n"
    want = _rewritten("runtime/native")
    got = _read(PORT_PKG, "runtime/native")
    assert got[got.index(marker):] == want[want.index(marker):]
    head = got[: got.index(marker)]
    assert "_build" in head and "os.replace" in head
    assert '"make"' not in head and 'libguac_runtime.so"' not in head


def test_read_source_differs_only_in_the_name_of_the_dense_switch():
    """callers/source.py: iter_tiles asks the port's dispatch whether the
    fused dense kernel wants full tiles, under the port's name for that
    switch (dense_tiles, GUAC_DENSE_TILES=1) where the original asks
    use_pallas (GUAC_USE_PALLAS=1 on a TPU)."""
    want = _rewritten("callers/source")
    assert want.count("use_pallas") == 2 and "fused Pallas kernel" in want
    want = want.replace("use_pallas", "dense_tiles").replace(
        "fused Pallas kernel", "fused dense kernel")
    got = _read(PORT_PKG, "callers/source")
    # The module docstrings differ; compare from the imports on.
    start = "from __future__ import annotations"
    assert got[got.index(start):] == want[want.index(start):]


def _without(text, cuts):
    """text with each (start marker, end marker) span removed; every
    marker must be there."""
    for start, end in cuts:
        a = text.index(start)
        text = text[:a] + text[text.index(end, a):]
    return text


def test_somatic_caller_differs_only_in_the_device_plumbing():
    """callers/somatic_standard.py: the port's copy differs from the
    original in call_variants' screen wiring (an explicit device, no mesh),
    in _try_streaming and in main (--device, the refusals, no
    multi-process helpers). Everything else is the original after the
    rename: the exact f64 kernels, the filters, the confirm stage and the
    naive left fold of the normal-likelihood total."""
    want = _rewritten("callers/somatic_standard")
    got = _read(PORT_PKG, "callers/somatic_standard")
    start = "from __future__ import annotations"
    plumbing = [
        # call_variants, from its signature to the confirm stage
        ("def call_variants(", "    def confirm("),
        # the screen iterator inside call_variants
        ("    def screened():", "        for (contig, tile, tumor, normal), pending"),
        ("def _try_streaming(", "def main("),
        ("def main(", "    progress(\"Computed %d potential genotypes.\""),
        ("    records = ", "    return 0"),
    ]
    want = _without(want[want.index(start):], plumbing).replace(
        "import numpy as np\n", "import numpy as np\nimport torch\n", 1)
    assert _without(got[got.index(start):], plumbing) == want
    # Both naive folds (the per-locus one and the batched one) lie in the
    # part held equal.
    assert want.count("normal_variants_total += ") == 2
    assert "sum(" not in "".join(
        line for line in want.splitlines(True) if "normal_variants_total" in line
    )


def test_platform_keeps_the_allocator_tuning_only():
    """platform.py: tune_allocator is the original's; the JAX platform
    selection is replaced by device(), which never falls back to the CPU
    unasked."""
    import torch

    from guacamole_tpu_torch import platform as port_platform

    assert _function_source(
        _read(PORT_PKG, "platform"), "tune_allocator"
    ) == _function_source(_read(JAX_PKG, "platform"), "tune_allocator")
    assert port_platform.device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_platform.device("tpu")
    if not torch.cuda.is_available():
        for requested in (None, "cuda"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                port_platform.device(requested)


def test_port_native_runtime_builds_into_the_ports_build_dir():
    from guacamole_tpu_torch.runtime import native

    lib = native.load_library()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(PORT_PKG, "_build")
