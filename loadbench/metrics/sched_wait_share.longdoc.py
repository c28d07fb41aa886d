"""The scheduler's wait for a request with no row active: the part of its
``sched.wait`` spans inside the window over the window's seconds, as a
percentage."""

from loadbench.spans import share_of_window


def read(run):
    return share_of_window(run, "sched.wait")
