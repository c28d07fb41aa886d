"""K1's share of its roofline: the summed ``flash_bound`` (the window cuts
the keys) of the calls recorded in the profiled stretch over K1's summed
device time there."""

from loadbench.readers import roofline


def read(run):
    return roofline(run, "k1", "flash_prefill")
