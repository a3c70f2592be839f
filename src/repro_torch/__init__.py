"""PyTorch/CUDA port of the MSCCL++ reproduction (``repro``).

The port keeps the reference package's module names so each
counterpart is easy to find (``repro.core.comm`` ->
``repro_torch.core.comm`` and so on). It imports torch and numpy, never
jax and nothing of ``repro``: the pure-Python DSL layer is copied, not
shared, because ``repro.core`` eagerly imports its Pallas executor.

Tensor-parallel ranks live on one device as a *rank-stacked* leading
axis (``x[r]`` is rank ``r``'s buffer, the ``kernels/ref.py``
convention); see :mod:`repro_torch.mesh`. Entry points run on CUDA
unless the caller passes ``device="cpu"``.

Submodules are imported on demand; importing the package touches no
device and builds no kernel.
"""
