"""Most device memory allocated during the traced window
(torch.cuda.max_memory_allocated after a reset at its start), in MiB."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**20
