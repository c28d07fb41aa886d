"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 -m loadbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is a file found by its name: the model
configuration under ``configs/`` (naming its family: the weights and the
program built from them under ``families/``, the plain reference under
``reference/``), the traffic mix under ``traffic/`` (read by a generator
under ``traffic/kinds/``), the cell under ``workloads/`` (naming its entry
under ``entries/`` and its comparison under ``checks/``), and one reader
per metric under ``metrics/``. The yardstick (percentiles, the trace's
busy time, rooflines, FLOP counts, the chip's peaks), the references and
the checks that decide ``correct`` live here too, so that a change to the
program cannot move them.
"""
