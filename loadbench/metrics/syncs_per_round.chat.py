"""Waits on the device a round: the program's ``sync`` spans over its
``session.round`` spans, in the window."""

from loadbench.spans import syncs_per_round as read  # noqa: F401
