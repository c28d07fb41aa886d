"""AR and self-speculative generation engines."""
