"""K2's share of its roofline from the program's own records of its calls
(``RECORDS.k2``, kept while the profiler records): the summed
``paged_bound`` over K2's summed device time in the profiled stretch."""

from loadbench.spans import roofline_from_records


def read(run):
    return roofline_from_records(run, "k2", "paged_decode_kernel")
