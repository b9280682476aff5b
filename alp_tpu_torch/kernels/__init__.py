"""The port's decode kernels (CUDA, built by ``_build``) and decode plans."""
