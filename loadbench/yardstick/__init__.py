"""The benchmark's own arithmetic: statistics, the device trace's busy
time, rooflines, model FLOPs and the chip's published peaks."""
