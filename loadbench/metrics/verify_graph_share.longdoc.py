"""Share of the window's early-exit verify passes that replayed the
session's verify graph (``spec.verify`` spans with ``graph=1``), as a
percentage."""

from loadbench.verify_spans import graph_share as read  # noqa: F401
