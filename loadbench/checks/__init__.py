"""Comparisons that decide ``correct``, one file each, named by a cell's
``check`` setting (``gap`` where it names none): ``read(reference, weights,
hf, requests)`` takes the family's reference module, the run's weights,
the configuration and the sample of served requests (``check.Served``,
with the program's ``records``), and returns the numbers that the cell's
``limits`` name."""
