"""The scheduler loop's own share of the window: the part inside it of each
``sched.loop`` span less its ``sched.wait``, ``session.insert`` and
``session.step`` children (the benchmark's wrappers around insert and step
stay in it), over the window's seconds, as a percentage."""

from loadbench.spans import sched_self_share as read  # noqa: F401
