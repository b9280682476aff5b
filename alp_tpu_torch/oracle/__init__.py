"""Host-side planning oracles of the port (NumPy only)."""
