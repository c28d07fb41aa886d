"""Plain PyTorch references that decide ``correct``. They import neither
JAX nor anything of the program under test."""
