"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 -m loadbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is a file found by its name: the model
configuration under ``configs/``, the traffic mix under ``traffic/`` (read by
a generator under ``traffic/kinds/``), the cell under ``workloads/`` (naming
its entry under ``entries/``), and one reader per metric under
``metrics/``. The yardstick (percentiles, the trace's busy time, rooflines,
FLOP counts, the chip's peaks) and the plain reference that decides
``correct`` live here too, so that a change to the program cannot move
them.
"""
