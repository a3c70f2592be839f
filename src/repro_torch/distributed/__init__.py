"""Tensor-parallel decode: rank slicing of params and the serve step."""
