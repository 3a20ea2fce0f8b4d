"""Fisher's exact test helper (cf. reference
.../filters/FishersExactTest.scala:23-30)."""

from __future__ import annotations

import math


def _log_binomial(n: int, k: int) -> float:
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def fishers_exact_test(
    total_a: int, total_b: int, condition_a: int, condition_b: int
) -> float:
    """Hypergeometric point probability of the observed 2x2 table."""
    return math.exp(
        _log_binomial(total_a, condition_a)
        + _log_binomial(total_b, condition_b)
        - _log_binomial(total_a + total_b, condition_a + condition_b)
    )
