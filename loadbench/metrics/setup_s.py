"""Process start to the window's opening, the ramp included."""


def read(run):
    return run.setup_s
