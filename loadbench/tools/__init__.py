"""Tools for setting a cell's rate, tail_eps and limits on the chip."""
