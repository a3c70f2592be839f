"""Async, DP-independent checkpointing (port of
``repro.train.checkpoint``), in the reference's layout:

    <dir>/step_<N>/manifest.json + leaf_<i>.npy

Leaf ``i`` is the leaf that ``jax.tree.flatten`` numbers ``i`` (dict keys
in sorted order, :mod:`repro_torch.tree`), so the two packages read each
other's f32 checkpoints. The manifest records the step and each leaf's
shape and dtype. A checkpoint holds one copy of the params and the
optimizer state, whatever the DP grid that wrote it, so a run resumes on
another grid (elastic re-ranking).

numpy has no bfloat16 without ``ml_dtypes``, which the port does not
need: a bf16 leaf is saved as its raw 2-byte words (uint16) with
``"bfloat16"`` in the manifest, and restored through a uint16 view.

Writes go through a background thread (training goes on while the
previous step serializes), with an atomic directory rename so a crash
mid-write never corrupts the latest checkpoint. ``keep_n`` prunes old
steps.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib

__all__ = ["save", "save_async", "restore", "latest_step", "latest_steps",
           "wait_pending"]

_PENDING: list[threading.Thread] = []


def _host(x) -> np.ndarray:
    """A leaf as a numpy array on the host (a bf16 tensor as its uint16
    words)."""
    if isinstance(x, np.ndarray):
        return x
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(x.dtype)


def _snapshot(tree):
    """(host arrays, their dtype names) in the reference's leaf order."""
    leaves = tree_lib.leaves(tree)
    return [_host(x) for x in leaves], [_dtype_name(x) for x in leaves]


def save(ckpt_dir, step: int, tree, *, keep_n: int = 3) -> Path:
    """Write ``tree`` (tensors or numpy arrays) as ``step_<step>``."""
    return _write(Path(ckpt_dir), step, *_snapshot(tree), keep_n=keep_n)


def _write(ckpt_dir: Path, step: int, host, dtypes, *, keep_n: int) -> Path:
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "treedef": f"{len(host)} leaves in jax.tree order",
        "leaves": [{"shape": list(x.shape), "dtype": dt}
                   for x, dt in zip(host, dtypes)],
    }
    for i, x in enumerate(host):
        np.save(tmp / f"leaf_{i}.npy", x)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish

    for s in latest_steps(ckpt_dir)[:-keep_n]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return final


def save_async(ckpt_dir, step: int, tree, *,
               keep_n: int = 3) -> threading.Thread:
    """Snapshot to host memory now (a device-to-host copy of every
    leaf), serialize in a background thread (the expensive part overlaps
    with training). :func:`wait_pending` joins it."""
    host, dtypes = _snapshot(tree)
    t = threading.Thread(target=_write, args=(Path(ckpt_dir), step, host,
                                              dtypes),
                         kwargs=dict(keep_n=keep_n), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_steps(ckpt_dir) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))


def latest_step(ckpt_dir) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaf(path: Path, dtype_name: str) -> torch.Tensor:
    x = np.load(path)
    if dtype_name == "bfloat16":
        # the raw words (uint16 here, a 2-byte type from a writer with
        # ml_dtypes)
        return torch.from_numpy(
            np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def restore(ckpt_dir, tree_like, step: Optional[int] = None):
    """``(tree, step)``: the checkpoint read into the structure of
    ``tree_like``, each leaf cast to that leaf's dtype and placed on its
    device (default: the latest step)."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = tree_lib.leaves(tree_like)
    if len(manifest["leaves"]) != len(like):
        raise ValueError(f"checkpoint {d} holds {len(manifest['leaves'])} "
                         f"leaves, the tree {len(like)}")
    out = []
    for i, (ref, meta) in enumerate(zip(like, manifest["leaves"])):
        x = _load_leaf(d / f"leaf_{i}.npy", meta["dtype"])
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint {tuple(x.shape)} vs "
                             f"model {tuple(ref.shape)}")
        out.append(x.to(device=ref.device, dtype=ref.dtype))
    return tree_lib.unflatten(tree_like, out), step
