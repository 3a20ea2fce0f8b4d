"""The reference of germline-threshold: the flags it takes, their defaults,
the VCF data lines, and the control (the share compared as a real number,
where the configuration states an integer percent)."""

from reference.callers import germline_threshold

FLAGS = {"--reads": ("reads", str), "--threshold": ("threshold", int)}
DEFAULTS = {"threshold": 8}


def call(sample, options: dict):
    return germline_threshold(sample, options["reads"], options["threshold"])


def control(sample, options: dict):
    return germline_threshold(sample, options["reads"], options["threshold"],
                              floor_percent=False)
