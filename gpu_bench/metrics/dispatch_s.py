"""Host seconds a call spends in ops/dispatch.py: staging a tile into
pinned buffers, the copies and launches, and waiting for the results."""


def read(run):
    return run.layer_per_call("dispatch")
