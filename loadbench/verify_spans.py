"""Readings of the attributes on the program's ``spec.verify`` spans, for
the metric files that name them."""

from __future__ import annotations

from typing import Optional

from loadbench.spans import window_spans


def graph_share(run) -> Optional[float]:
    """The share, as a percentage, of the early-exit verify passes (with
    acceptance and commit; ``spec.verify`` spans) started in the window
    that replayed the session's verify graph (``graph=1``). None where no
    verify span in the window says either way (a program without the
    attribute)."""
    w = window_spans(run)
    if w is None:
        return None
    flags = [bool(s.attrs["graph"]) for s in w.of("spec.verify") if "graph" in s.attrs]
    if not flags:
        return None
    return 100.0 * sum(flags) / len(flags)
