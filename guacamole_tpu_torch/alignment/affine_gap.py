"""Affine-gap-penalty pairwise alignment in -log probability space.

(cf. reference .../alignment/AffineGapPenaltyAlignment.scala:6-142,
ReadAlignment.scala:5-63)
Local-in-reference alignment of a read against a reference window, with a
run-length-encoded CIGAR output. Used by re-alignment utilities.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


class AlignmentState(enum.Enum):
    MATCH = "Match"
    MISMATCH = "Mismatch"
    INSERTION = "Insertion"
    DELETION = "Deletion"


def is_gap_alignment(state: AlignmentState) -> bool:
    return state in (AlignmentState.INSERTION, AlignmentState.DELETION)


_CIGAR_KEY = {
    AlignmentState.MATCH: "=",
    AlignmentState.MISMATCH: "X",
    AlignmentState.INSERTION: "I",
    AlignmentState.DELETION: "D",
}


@dataclass
class ReadAlignment:
    alignments: List[AlignmentState]
    ref_bases: bytes
    alignment_score: int

    def to_cigar(self) -> str:
        """Run-length encode the alignment states into a CIGAR string."""
        if not self.alignments:
            return ""
        out = []
        last = self.alignments[0]
        run = 1
        for state in self.alignments[1:]:
            if state == last:
                run += 1
            else:
                out.append(f"{run}{_CIGAR_KEY[last]}")
                last = state
                run = 1
        out.append(f"{run}{_CIGAR_KEY[last]}")
        return "".join(out)


Path = Tuple[int, List[AlignmentState], float]  # (ref start idx, states, score)


def score_alignment_paths(
    sequence: bytes,
    reference: bytes,
    mismatch_probability: float,
    open_gap_probability: float,
    close_gap_probability: float,
) -> List[Path]:
    log_mismatch_penalty = -math.log(mismatch_probability)
    log_open_gap_penalty = -math.log(open_gap_probability)
    no_gap_penalty = -math.log(1 - open_gap_probability)
    log_close_gap_penalty = -math.log(close_gap_probability)
    log_continue_gap_penalty = -math.log(1 - close_gap_probability)

    seq_len = len(sequence)
    ref_len = len(reference)

    last_row: List[Path] = [(r, [], 0.0) for r in range(ref_len + 1)]

    def transition_penalty(
        next_state: AlignmentState,
        previous_state: Optional[AlignmentState],
        is_end_state: bool,
    ) -> float:
        open_gap = previous_state != next_state and is_gap_alignment(next_state)
        close_gap = (
            previous_state is not None
            and next_state != previous_state
            and is_gap_alignment(previous_state)
        )
        continue_gap = previous_state == next_state and is_gap_alignment(next_state)
        mismatch = next_state is AlignmentState.MISMATCH
        penalty = 0.0
        if open_gap:
            penalty += log_open_gap_penalty
        if close_gap:
            penalty += log_close_gap_penalty
        if continue_gap:
            penalty += log_continue_gap_penalty
        elif mismatch:
            penalty += no_gap_penalty + log_mismatch_penalty
        else:
            penalty += no_gap_penalty
        if is_end_state and is_gap_alignment(next_state):
            penalty += log_close_gap_penalty
        return penalty

    for seq_idx in range(1, seq_len + 1):
        current_row: List[Path] = [None] * (ref_len + 1)  # type: ignore
        for ref_idx in range(ref_len + 1):
            candidates: List[Path] = []
            for prev_seq, prev_ref in (
                (seq_idx - 1, ref_idx),
                (seq_idx, ref_idx - 1),
                (seq_idx - 1, ref_idx - 1),
            ):
                if prev_seq < 0 or prev_ref < 0:
                    continue
                if seq_idx == prev_seq:
                    next_state = AlignmentState.DELETION
                    prev_path = current_row[ref_idx - 1]
                elif ref_idx == prev_ref:
                    next_state = AlignmentState.INSERTION
                    prev_path = last_row[ref_idx]
                elif sequence[seq_idx - 1] != reference[ref_idx - 1]:
                    next_state = AlignmentState.MISMATCH
                    prev_path = last_row[ref_idx - 1]
                else:
                    next_state = AlignmentState.MATCH
                    prev_path = last_row[ref_idx - 1]
                prev_start, prev_states, prev_score = prev_path
                prev_state = prev_states[-1] if prev_states else None
                cost = transition_penalty(
                    next_state, prev_state, is_end_state=(seq_idx == seq_len)
                )
                candidates.append(
                    (prev_start, prev_states + [next_state], prev_score + cost)
                )
            current_row[ref_idx] = min(candidates, key=lambda p: p[2])
        last_row = current_row
    return last_row


def align(
    sequence: bytes,
    reference: bytes,
    mismatch_probability: float = math.exp(-4),
    open_gap_probability: float = math.exp(-6),
    close_gap_probability: float = 1 - math.exp(-1),
) -> ReadAlignment:
    """Best-scoring alignment of sequence against any span of reference."""
    final_row = score_alignment_paths(
        sequence,
        reference,
        mismatch_probability,
        open_gap_probability,
        close_gap_probability,
    )
    best_end, (ref_start, states, score) = min(
        enumerate(final_row), key=lambda pair: pair[1][2]
    )
    return ReadAlignment(states, reference[ref_start:best_end], int(score))
