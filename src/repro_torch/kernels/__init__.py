"""Collective kernels of the port: the CUDA build helper and the
plain torch oracles."""
