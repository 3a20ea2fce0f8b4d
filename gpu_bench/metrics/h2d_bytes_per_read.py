"""Bytes copied host to device per read called, from the dispatch's own
counter (ops/dispatch.py TRANSFER_STATS["h2d_bytes"])."""


def read(run):
    if run.reads_total <= 0:
        return None
    return run.transfer.get("h2d_bytes", 0) / run.reads_total
