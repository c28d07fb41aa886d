"""Model FLOPs of the work delivered over the host seconds the port spent
inside its calls, over the chip's bf16 peak (989 TFLOP/s), as a percentage;
over the window (the profiler is off there)."""

from loadbench.readers import step_mfu as read  # noqa: F401
