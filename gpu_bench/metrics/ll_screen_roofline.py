"""The likelihood screen's share of its roofline (rooflines/ll_screen.py)
over the window's launches, in %."""


def read(run):
    return run.roofline("ll_screen")
