"""Collective kernels of the port: the library behind the standard
collective API (``ops``: 1PA and 2PA AllReduce, all-pairs ReduceScatter
and AllGather, ring AllGather, all-pairs AllToAll), each a hand-written
CUDA kernel in ``csrc/`` with its plain torch version beside it; the
CUDA build helper; and the plain torch oracles (``ref``)."""
