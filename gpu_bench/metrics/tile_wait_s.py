"""Seconds a call's main thread waits for the packing thread: the
program's own `tiles.get` waits on prefetch_iter's tile queue
(guacamole_tpu_torch/utils/trace.py, recorded while the traced window's
profiler records), summed over the window and divided by its calls. None
where the program records no spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    seconds = trace.seconds("tiles.get")
    if seconds is None or not run.calls:
        return None
    return seconds / run.calls
