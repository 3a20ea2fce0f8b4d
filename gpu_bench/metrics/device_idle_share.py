"""Share of the traced window in which nothing ran on the device (no
kernel, copy or set in torch.profiler's trace), in %."""


def read(run):
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
