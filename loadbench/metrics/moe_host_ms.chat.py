"""Host milliseconds of the MoE layer calls a round: the program's ``moe``
spans (each ``moe_mlp`` call, the inserts' included) over its
``session.round`` spans, in the window."""

from loadbench.moe_spans import host_ms_per_round as read  # noqa: F401
