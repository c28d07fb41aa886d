"""K1's share of its roofline: the summed ``flash_bound`` (the window cuts
the keys) of the calls the program recorded in the profiled stretch
(``RECORDS.k1``) over K1's summed device time there."""

from loadbench.spans import roofline_from_records


def read(run):
    return roofline_from_records(run, "k1", "flash_prefill")
