"""Seconds a call's packing thread waits for the streaming decode: the
program's own `decode.wait` waits for a partition task's decoded reads
(callers/streaming.py, utils/trace.py), summed over the traced window and
divided by its calls. None where the program records no spans."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own spans
        return None
    seconds = trace.seconds("decode.wait")
    if seconds is None or not run.calls:
        return None
    return seconds / run.calls
