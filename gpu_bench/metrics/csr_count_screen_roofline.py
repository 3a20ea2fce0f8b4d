"""The counting screen's share of its roofline (rooflines/csr_count_screen.py)
over the window's launches, in %."""


def read(run):
    return run.roofline("csr_count_screen")
