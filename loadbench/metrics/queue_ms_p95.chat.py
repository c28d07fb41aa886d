"""95th percentile, over the window's requests, of the time from when a
request was due to the scheduler's own admission stamp
(``_Request.t_start``); one never admitted is missing."""

import math

from loadbench.yardstick.stats import percentile


def read(run):
    waits = [math.inf if r.queue_s is None else r.queue_s for r in run.window_requests]
    v = percentile(waits, 95)
    return None if v is None or math.isinf(v) else v * 1e3
