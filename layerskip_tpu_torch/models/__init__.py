"""Llama decoder and its parameters."""
