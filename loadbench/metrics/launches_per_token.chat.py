"""Device kernels in the profiled stretch per output token committed in it."""

from loadbench.readers import launches_per_token as read  # noqa: F401
