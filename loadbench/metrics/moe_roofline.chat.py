"""The MoE layer's share of its roofline: the summed ``moe_bound`` (the
experts each call hit read once, or its routed FLOPs) of the calls the
program recorded in the profiled stretch (``RECORDS.moe``) over the device
time under the MoE range (``loadbench.moe_mlp``) there, as a percentage."""

from loadbench.moe_spans import roofline as read  # noqa: F401
