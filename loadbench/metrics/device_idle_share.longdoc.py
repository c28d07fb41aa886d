"""Share of the profiled stretch in which no kernel ran, as a percentage."""

from loadbench.readers import idle_share as read  # noqa: F401
