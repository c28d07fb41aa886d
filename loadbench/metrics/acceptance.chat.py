"""Accepted over drafted tokens of the requests completed in the window (the
scheduler's ``acceptance_sum`` / ``completed``), as a percentage."""

from loadbench.readers import acceptance as read  # noqa: F401
