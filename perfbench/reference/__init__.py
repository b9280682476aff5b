"""The benchmark's plain reference (numpy and PyTorch, nothing of the
program)."""
