"""Plain PyTorch tensor ops of the port: FastLanes packing, ALP_RD split."""
