"""Seconds a call's packing thread waits for the main thread (the
callers): the program's own `tiles.put` waits for room in prefetch_iter's
full tile queue (utils/trace.py), summed over the traced window and
divided by its calls. None where the program records no spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    seconds = trace.seconds("tiles.put")
    if seconds is None or not run.calls:
        return None
    return seconds / run.calls
