"""Seconds a call's main thread waits for somatic-standard's sparse packs:
the program's own `confirm.wait` waits on each tumor/normal pack pair
(callers/somatic_standard.py, utils/trace.py), summed over the traced
window and divided by its calls. None where the program records no such
spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    # screen.rows is counted on every traced somatic call of a program
    # that records the confirm's spans.
    if not run.calls or "screen.rows" not in trace.snapshot()["counters"]:
        return None
    return trace.seconds("confirm.wait") / run.calls
