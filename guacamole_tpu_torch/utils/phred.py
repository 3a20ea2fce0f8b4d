"""Phred-scale probability conversions.

Semantics match the conversions used throughout the reference caller
(ADAM PhredUtils as used at e.g. reference .../Likelihood.scala:48-50,
AlleleEvidence.scala:52): success probability = 1 - 10^(-phred/10), and
probability -> phred rounds -10*log10(error).
"""

from __future__ import annotations

import math

import numpy as np


def phred_to_error_probability(phred) -> float:
    return 10.0 ** (phred / -10.0)


def phred_to_success_probability(phred) -> float:
    """1 - 10^(-phred/10); vectorizes over numpy arrays."""
    if isinstance(phred, np.ndarray):
        return 1.0 - np.power(10.0, phred / -10.0)
    return 1.0 - 10.0 ** (phred / -10.0)


def error_probability_to_phred(prob: float) -> int:
    """-10 * log10(prob), rounded — with the JVM's edge arithmetic.

    The reference feeds Math.log10 unchecked (AlleleEvidence.scala:52,
    GenotypeFilter.scala:135), and in the deep-pileup subnormal window
    its own normalization can yield "probabilities" above 1
    (DEVIATIONS #11), making the error probability here NEGATIVE. Java:
    Math.log10(negative) returns NaN and Math.round(NaN) returns 0, so
    the reference silently carries GQ 0 (and its min-likelihood filter
    drops the call); Python's throwing math.log10 would crash instead.
    log10(+0.0) is -Infinity and Math.round(+Infinity) is
    Long.MAX_VALUE — reproduced likewise. Found by the round-5 fuzz
    campaign over the exact-confirm emission path."""
    if prob < 0.0 or math.isnan(prob):
        return 0  # Math.round(NaN) == 0
    if prob == 0.0:
        return (1 << 63) - 1  # Math.round(+Infinity) == Long.MAX_VALUE
    return int(round(-10.0 * math.log10(prob)))


def success_probability_to_phred(prob: float) -> int:
    """Phred-scale a success probability (callers subtract a small delta
    before calling this to avoid log(0), cf. AlleleEvidence.scala:52)."""
    return error_probability_to_phred(1.0 - prob)
