"""Host seconds a call spends in somatic-standard's sparse packs of the
flagged loci, tumor and normal: the program's own `pack.sparse` spans on
the confirm's two executor threads (callers/somatic_standard.py,
utils/trace.py), summed over the threads and the traced window and divided
by its calls. None where the program records no such spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    # screen.rows is counted on every traced somatic call of a program
    # that records the confirm's spans.
    if not run.calls or "screen.rows" not in trace.snapshot()["counters"]:
        return None
    return trace.seconds("pack.sparse") / run.calls
