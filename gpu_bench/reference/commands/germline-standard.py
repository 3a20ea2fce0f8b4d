"""The reference of germline-standard: the flags it takes, their defaults,
the VCF data lines, and the control (the likelihoods in float32, where the
configuration states the exact float64 confirm)."""

from reference.callers import germline_standard

FLAGS = {"--reads": ("reads", str), "--min-mapq": ("min_mapq", int)}
DEFAULTS = {"min_mapq": 1}


def call(sample, options: dict):
    return germline_standard(sample, options["reads"], options["min_mapq"])


def control(sample, options: dict):
    return germline_standard(sample, options["reads"], options["min_mapq"],
                             dtype="f32")
