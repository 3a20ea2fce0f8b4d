"""Seconds a call's main thread waits for the device's results: the
program's own `dispatch.fetch` waits on each launch's CUDA event
(ops/dispatch.py _Fetch.wait, utils/trace.py), summed over the traced
window and divided by its calls. None where the program records no
spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    seconds = trace.seconds("dispatch.fetch")
    if seconds is None or not run.calls:
        return None
    return seconds / run.calls
