"""Carry weights from the reference to the port.

``params_from_jax`` takes the reference's ``transformer.init_params``
tree as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's params — the same nesting, torch tensors in the config's
dtype on ``device``. The port itself never imports jax; a caller that
holds the reference's arrays converts them here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.mesh import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_jax"]


def params_from_jax(np_tree, cfg: ModelConfig, *,
                    device: DeviceLike = None):
    """Reference param tree (numpy leaves, any float dtype incl. bf16)
    -> port params on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [conv(v) for v in leaf]
        # via float32: exact for bf16/f16 leaves, which numpy cannot hand
        # to torch directly
        arr = np.array(leaf, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=cfg.tdtype)

    return conv(np_tree)
