"""Drivers of the program, one per kind of entry point a cell names."""
