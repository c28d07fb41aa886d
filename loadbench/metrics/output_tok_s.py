"""Output tokens delivered in the window over its seconds: every returned
request's tokens, in the share of its time (from when it was due to when it
came back) that lies inside the window (``Run.tokens_in_window``)."""

from loadbench.yardstick.stats import rate


def read(run):
    return rate(run.tokens_in_window(), run.seconds)
