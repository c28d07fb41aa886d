"""Host milliseconds inside ``ContinuousSession.step`` per draft+verify
round it ran, over the window (``step`` ends in its one device-to-host
read)."""


def read(run):
    s = run.measured
    return s.step_s / s.rounds * 1e3 if s.rounds else None
