"""Diploid genotype likelihoods, plain, in float64 or float32.

log L(a1, a2) = sum_e log(p(a1, e) + p(a2, e)) - depth * log 2, with
p(a, e) = s_e where e carries a, else 1 - s_e; s_e = 1 - 10^(-q/10), times
1 - 10^(-mapq/10) when alignment counts. The sum runs over the elements
from the last to the first, one addition at a time, and normalisation sums
exp(log L) over the genotypes in their order (a1 <= a2 over the sorted
alleles), as Guacamole's Likelihood.scala does; below exp's precision
(a largest log L under -700) it is shifted by that maximum. Frozen from
the port's likelihood.py and utils/phred.py for the arithmetic, so that
float64 here gives the program's bits; float32 is the control.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_EXP_PRECISION_FLOOR = -700.0


class Arith:
    """The arithmetic of one precision: float64 (Python's math, as the
    program) or float32 (numpy float32 scalars)."""

    def __init__(self, dtype: str):
        if dtype not in ("f64", "f32"):
            raise ValueError(dtype)
        self.dtype = dtype
        self.np = np.float64 if dtype == "f64" else np.float32

    def success(self, phred: int):
        if self.dtype == "f64":
            return 1.0 - 10.0 ** (phred / -10.0)
        f = np.float32
        return f(1.0) - np.power(f(10.0), f(phred) / f(-10.0))

    def log(self, v):
        if self.dtype == "f64":
            return math.log(v) if v > 0.0 else float("-inf")
        v = np.float32(v)
        with np.errstate(divide="ignore"):
            return np.log(v) if v > 0 else np.float32(-np.inf)

    def exp(self, v):
        return math.exp(v) if self.dtype == "f64" else np.exp(np.float32(v))

    def log_total(self, lls: Sequence) -> float:
        """log(sum(exp(lls))) in order; shifted by the max below exp's
        precision."""
        m = max((float(x) for x in lls), default=float("-inf"))
        zero = self.np(0.0)
        if m > _EXP_PRECISION_FLOOR:
            total = zero
            for x in lls:
                total = total + self.exp(x)
            return self.log(total)
        if not math.isfinite(m):
            return float("-inf")
        shifted = zero
        mm = self.np(m)
        for x in lls:
            shifted = shifted + self.exp(x - mm)
        return mm + self.log(shifted)


class TermTable:
    """log(p1 + p2) for a success probability s and 0, 1 or 2 of the
    genotype's alleles carried: log(2(1-s)), log(s + (1-s)), log(2s),
    each composed in the order the scalar formula composes it."""

    def __init__(self, arith: Arith, with_mapq: bool):
        self.a = arith
        self.with_mapq = with_mapq
        self._cache = {}

    def row(self, q: int, m: int):
        key = (q, m) if self.with_mapq else q
        row = self._cache.get(key)
        if row is None:
            a = self.a
            s = a.success(q)
            if self.with_mapq:
                s = s * a.success(m)
            ns = (1.0 - s) if a.dtype == "f64" else np.float32(1.0) - s
            row = (a.log(ns + ns), a.log(s + ns), a.log(s + s))
            self._cache[key] = row
        return row

    def matrix(self, quals, mapqs) -> np.ndarray:
        """[n, 3] terms of n elements."""
        out = np.empty((len(quals), 3), dtype=self.a.np)
        for i, (q, m) in enumerate(zip(quals.tolist(), mapqs.tolist())):
            out[i] = self.row(q, m)
        return out


def genotype_log_likelihoods(
    arith: Arith, ids: np.ndarray, terms: np.ndarray,
) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """(genotypes, normalised log likelihoods) over the dense ids present
    in `ids` (ids in sorted allele order; -1 marks an element whose allele
    is in no genotype), for elements in file order with their [n, 3]
    terms. Genotypes come as (i, j), i <= j, in order."""
    present = sorted(set(i for i in ids.tolist() if i >= 0))
    pairs = [(present[i], present[j]) for i in range(len(present))
             for j in range(i, len(present))]
    if not pairs:
        return [], np.empty(0, dtype=arith.np)
    a1 = np.asarray([p[0] for p in pairs])[:, None]
    a2 = np.asarray([p[1] for p in pairs])[:, None]
    carry = (ids[None, :] == a1).astype(np.int64) + (ids[None, :] == a2)
    t = np.take_along_axis(
        np.broadcast_to(terms[None, :, :], (len(pairs),) + terms.shape),
        carry[:, :, None], axis=2)[:, :, 0]
    depth = len(ids)
    # Last element first, one addition at a time (cumsum is sequential).
    acc = np.cumsum(t[:, ::-1], axis=1, dtype=arith.np)[:, -1]
    if arith.dtype == "f64":
        lls = (acc + math.log(1.0)) - math.log(2) * depth
    else:
        f = np.float32
        lls = (acc + f(0.0)) - f(math.log(2)) * f(depth)
    total = arith.log_total(lls)
    return pairs, np.asarray([x - total for x in lls], dtype=arith.np)


def error_probability_to_phred(prob: float) -> int:
    """round(-10 log10(prob)), with the JVM's answers at the edges: 0 for
    a negative or NaN argument, Long.MAX_VALUE for 0, Long.MIN_VALUE for
    infinity (which only float32 arithmetic reaches)."""
    if prob < 0.0 or math.isnan(prob):
        return 0
    if prob == 0.0:
        return (1 << 63) - 1
    if math.isinf(prob):
        return -(1 << 63)
    return int(round(-10.0 * math.log10(prob)))


def success_probability_to_phred(prob: float) -> int:
    return error_probability_to_phred(1.0 - prob)
