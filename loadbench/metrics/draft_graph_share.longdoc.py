"""Share of the window's early-exit draft passes that replayed the
session's CUDA graph (``spec.draft`` spans with ``graph=1``), as a
percentage."""

from loadbench.draft_spans import graph_share as read  # noqa: F401
