"""The tumor likelihood screen's selectivity: rows that somatic-standard's
screen hands on to the confirm (the program's counter `screen.flagged`:
flagged or overflowing rows with reads) per 1,000 rows screened
(`screen.rows`), callers/somatic_standard.py, over the traced window. None
where the program counts neither."""


def read(run):
    try:
        from guacamole_tpu_torch.utils import trace
    except ImportError:  # a program without its own counters
        return None
    counters = trace.snapshot()["counters"]
    if not counters.get("screen.rows"):
        return None
    return 1000.0 * counters.get("screen.flagged", 0) / counters["screen.rows"]
