"""Carry weights from the reference to the port.

``params_from_jax`` takes the reference's ``transformer.init_params``
tree as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's params — the same nesting, torch tensors in the config's
dtype on ``device``; the rwkv6 family's 21 leaves a layer among them
(``w_base`` and ``u`` ``(groups, nh, 64)``). ``rwkv_state_from_jax`` and
``rwkv_state_to_jax`` carry an rwkv6 decode cache between the
reference's dict of ``(groups, ...)`` arrays and the port's layout (a
list of one leaf a name). The port itself never imports jax; a caller
that holds the reference's arrays converts them here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.mesh import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import STATE_NAMES

__all__ = ["params_from_jax", "rwkv_state_from_jax", "rwkv_state_to_jax"]


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


def rwkv_state_from_jax(np_cache: dict, *,
                        device: DeviceLike = None) -> dict:
    """The reference's rwkv6 cache (``transformer.init_cache``'s dict of
    f32 ``(groups, b, ...)`` arrays, as numpy) -> the port's, ``{name:
    [leaf]}`` on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    return {name: [torch.from_numpy(np.array(np_cache[name],
                                             dtype=np.float32)).to(device)]
            for name in STATE_NAMES}


def rwkv_state_to_jax(cache: dict) -> dict:
    """The port's rwkv6 cache -> the reference's layout as numpy f32
    arrays (``jnp.asarray`` of each makes the reference's cache)."""
    return {name: cache[name][0].detach().cpu().numpy()
            for name in STATE_NAMES}
