"""Host seconds a call spends in somatic-standard's exact f64 confirm: the
program's own `confirm` spans (the flagged rows batched into
somatic_calls_from_row_pairs) and `confirm.pileup` spans (one pileup at a
time for rows that overflow a tile), callers/somatic_standard.py, summed
over the traced window and divided by its calls. None where the program
records no such spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    # screen.rows is counted on every traced somatic call of a program
    # that records the confirm's spans.
    if not run.calls or "screen.rows" not in trace.snapshot()["counters"]:
        return None
    return (trace.seconds("confirm") + trace.seconds("confirm.pileup")) / (
        run.calls)
