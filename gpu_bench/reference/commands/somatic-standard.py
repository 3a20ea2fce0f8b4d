"""The reference of somatic-standard: the flags it takes, their defaults,
the VCF data lines, and the control (the likelihoods in float32, where the
configuration states the exact float64 confirm)."""

from reference.callers import somatic_standard

FLAGS = {"--tumor-reads": ("tumor", str), "--normal-reads": ("normal", str),
         "--odds": ("odds", int), "--min-mapq": ("min_mapq", int)}
DEFAULTS = {"odds": 20, "min_mapq": 1}


def call(sample, options: dict):
    return somatic_standard(sample, options["tumor"], options["normal"],
                            options["odds"], options["min_mapq"])


def control(sample, options: dict):
    return somatic_standard(sample, options["tumor"], options["normal"],
                            options["odds"], options["min_mapq"], dtype="f32")
