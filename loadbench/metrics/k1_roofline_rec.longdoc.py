"""K1's share of its roofline from the program's own records of its calls
(``RECORDS.k1``, kept while the profiler records): the summed
``flash_bound`` (the window cuts the keys) over K1's summed device time in
the profiled stretch."""

from loadbench.spans import roofline_from_records


def read(run):
    return roofline_from_records(run, "k1", "flash_prefill")
