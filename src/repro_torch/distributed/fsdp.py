"""FSDP (ZeRO-3) for the explicit trainer and the prefill step — the
port's counterpart of the reference's ``fsdp=True`` (``apply_fsdp``
specs, under which GSPMD "inserts the per-layer weight all-gathers").

**Layout** (:class:`FsdpLayout`). The specs are the reference's:
``apply_fsdp(param_pspecs(cfg, grid), shapes, grid, fsdp_axis=)`` on
the DP grid, which has no ``model`` axis (the port's trainer has no TP).
A leaf the specs shard on dim ``d`` is held rank-stacked,
``(nf, *shape)`` with ``shape[d]`` cut by the FSDP axis size ``nf``:
rank ``f`` of the axis holds block ``f`` of dim ``d`` and nothing else,
and so does the AdamW state (:func:`~repro_torch.train.optimizer.
adamw_init` over the held tree). A leaf the specs leave alone (under
2^16 elements, or no dim divides) is held whole. Two kinds of sharded
layer leaf arise, and both work:

* ``d == 0``, the ``groups`` dim (qwen3-1.7b's 28 groups at DP 4,
  llama2-70b's 80 at 16): one rank owns whole groups, ``groups / nf`` of
  them. Reaching group ``g`` is a **broadcast** from its owner;
* ``d >= 1``, an inner dim (qwen3-1.7b at DP 8 shards ``d_model``):
  every rank holds a slice of every group, and reaching a group is an
  **all-gather** along that dim.

**The step** (:class:`FsdpPass`). The ranks' passes run group by group
in lock step: a group's sharded leaves are gathered just before it runs
— one plan replay a leaf, on the executor kernel on the card and on
``TorchExecutor`` on the CPU — every rank runs the group on its rows,
and the gathered group is dropped. A rank therefore holds its shards and
the one gathered group the running group needs; the embedding and the
logits' weight are gathered the same way for the lookup and again for
the head. The forward keeps only each group's input; the backward
gathers each group again (last first), recomputes it under autograd and
takes its gradients (the reference's ``remat_policy="full"``; a graph
kept from the forward would hold every gathered group). The weights a
recomputation differentiates are the gathered group's own tensors (or a
whole leaf's one-group view), so autograd never holds a stacked leaf.

**The reduction.** The reference all-reduces every gradient and lets
GSPMD re-shard. Here a rank needs only its shard, so an inner-sharded
leaf is **reduce-scattered** (one plan replay, the ranks' shards out,
every rank's divided by the DP size); a group-owned leaf is
**all-reduced** and its owner keeps the group (no reduce-to-root plan
exists); a whole leaf is all-reduced once after the backward, as the
non-FSDP trainer reduces it. ``dp_wire_dtype`` casts every payload. With
two DP axes (``pod``, then the FSDP axis) the gathers run inside each
pod, a reduce-scatter is followed by an all-reduce over ``pod`` of the
shards, and an all-reduce runs over the FSDP axis and then ``pod``.

Auto mode has no ranks: there ``fsdp=True`` computes as the auto step
without it (``distributed/step.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed import sharding as shd
from repro_torch.mesh import NamedGrid
from repro_torch.models import transformer as tf
from repro_torch.models.blocks import rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["FsdpLayout", "FsdpComms", "FsdpPass", "dp_grid"]


def dp_grid(dp_axes) -> NamedGrid:
    """The DP grid of ``RankAxis`` es (outermost first)."""
    return NamedGrid(tuple(a.name for a in dp_axes),
                     tuple(a.n for a in dp_axes))


def _payload(x: torch.Tensor) -> torch.Tensor:
    """A rank-stacked ``x`` as a plan payload: ``(L, rows, last)``, or
    ``(L, n, 1)`` for one dim a rank."""
    cols = x.shape[-1] if x.dim() >= 3 else 1
    return x.reshape(x.shape[0], -1, cols)


class FsdpLayout:
    """Which dim of every leaf the FSDP axis shards, and the held tree.

    ``local`` is how many of the axis's shards this device holds: all
    ``nf`` on the card (the ranks are stacked), 1 when the dry run traces
    one rank."""

    def __init__(self, cfg: ModelConfig, grid: NamedGrid, *,
                 fsdp_axis: Optional[str] = None,
                 local: Optional[int] = None):
        self.cfg = cfg
        self.grid = grid
        self.axis = fsdp_axis or grid.axis_names[-1]
        self.nf = grid.shape[self.axis]
        self.local = self.nf if local is None else int(local)
        shapes = tf.init_params(cfg, device="meta")
        specs = shd.apply_fsdp(shd.param_pspecs(cfg, grid), shapes, grid,
                               fsdp_axis=self.axis)
        #: the params' structure, one sharded dim (or None) a leaf
        self.dims = shd.spec_map(
            lambda sp, _: sp.index(self.axis) if self.axis in sp else None,
            specs, shapes)
        #: the params as ``meta`` tensors: every leaf's shape and type
        self.meta = shapes
        self.groups = tf.n_groups(cfg)

    # -- the held tree -----------------------------------------------------
    def held_shape(self, shape, d) -> tuple:
        if d is None:
            return tuple(shape)
        s = list(shape)
        s[d] //= self.nf
        return (self.local,) + tuple(s)

    def shard(self, params: dict) -> dict:
        """The held tree of reference-layout ``params`` (new tensors)."""
        def one(p, d):
            if d is None:
                return p.clone()
            return (p.unflatten(d, (self.nf, p.shape[d] // self.nf))
                    .movedim(d, 0)[:self.local]
                    .clone(memory_format=torch.contiguous_format))
        return tree_lib.map_leaves(one, params, self.dims)

    def unshard(self, held: dict) -> dict:
        """The reference layout of a held tree (every shard held)."""
        def one(x, d):
            if d is None:
                return x
            return x.movedim(0, d).flatten(d, d + 1)
        return tree_lib.map_leaves(one, held, self.dims)

    def empty(self, device) -> dict:
        """An uninitialised held tree."""
        return tree_lib.map_leaves(
            lambda t, d: torch.empty(self.held_shape(t.shape, d),
                                     dtype=t.dtype, device=device),
            self.meta, self.dims)

    def group_leaves(self) -> list:
        """(slot, leaf key path, sharded dim) of every layer leaf, in the
        reference's leaf order within each slot."""
        out = []
        for i, slot in enumerate(self.dims["layers"]):
            for path, d in _paths(slot):
                out.append((i, path, d))
        return out

    def predicted_launches(self, *, backward: bool) -> int:
        """Plan replays of one step (each one executor launch): a group's
        sharded leaves gathered once in the forward and, with
        ``backward``, again in the backward, where each is also reduced;
        the embedding gathered for the lookup (integer tokens: an arch
        with no frontend) and the logits' weight for the head, each when
        sharded; after the backward every sharded root leaf reduced and
        every whole leaf all-reduced. With a second DP axis (``pod``) a
        reduction is two replays."""
        sharded = sum(d is not None for _, _, d in self.group_leaves())
        whole = sum(d is None for d in tree_lib.leaves(self.dims))
        head_w = "embed" if self.cfg.tie_embeddings else "unembed"
        n = self.groups * sharded * (2 if backward else 1)
        n += int(self.cfg.frontend == "none"
                 and self.dims["embed"] is not None)
        n += int(self.dims[head_w] is not None)
        if backward:
            per = 2 if len(self.grid.axis_names) > 1 else 1
            root_sharded = sum(self.dims[k] is not None
                               for k in ("embed", "ln_f", "unembed")
                               if k in self.dims)
            n += per * (self.groups * sharded + root_sharded + whole)
        return n


def _paths(tree, prefix=()):
    """(key path, leaf) of a dict tree in the reference's leaf order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class FsdpComms:
    """The FSDP step's collectives on rank-stacked payloads ``(L, rows,
    cols)`` of the ``L`` ranks this device runs, as compiled plans of the
    DP communicators (``{"flat": c}`` or ``{"node": pod, "local": c}``,
    the FSDP axis the flat or local one); each plan's kernel scratch is
    released after its replay. Any object with ``Communicator.compile``'s
    signature serves (the dry run's recorder)."""

    def __init__(self, comms: dict):
        self.inner = comms.get("local", comms.get("flat"))
        self.outer = comms.get("node")
        self.replays = 0

    def _replay(self, comm, collective, x, *, outer=False, **kw):
        n = comm.n
        L = x.shape[0]
        groups = L // n if L >= n and L % n == 0 else 1
        if outer:       # the pod axis: one group a local index, strided
            kw.update(groups=groups, stride=groups)
        else:
            kw.update(groups=groups)
        plan = comm.compile(collective, tuple(x.shape[1:]), x.dtype, **kw)
        out = plan(x.contiguous())
        plan.release()
        self.replays += 1
        return out

    def all_gather(self, x):
        return self._replay(self.inner, "all_gather", x)

    def broadcast(self, x, root: int):
        return self._replay(self.inner, "broadcast", x, root=root)

    def reduce_scatter(self, x):
        out = self._replay(self.inner, "reduce_scatter", x)
        if self.outer is not None:
            out = self._replay(self.outer, "all_reduce", out, outer=True)
        return out

    def all_reduce(self, x):
        out = self._replay(self.inner, "all_reduce", x)
        if self.outer is not None:
            out = self._replay(self.outer, "all_reduce", out, outer=True)
        return out


class FsdpPass:
    """The FSDP ranks' passes (see the module docstring) over a held tree.

    ``ranks``: the DP ranks this device runs, each on its rows of the
    global batch (rank = pod * nf + f): all of them on the card, ``(0,)``
    when the dry run traces one rank (then ``layout.local`` is 1)."""

    def __init__(self, cfg: ModelConfig, layout: FsdpLayout,
                 comms: FsdpComms, *, ndp: int, ranks=None,
                 dp_wire_dtype=None, backend: Optional[str] = "torch"):
        self.cfg = cfg
        self.layout = layout
        self.comms = comms
        self.ndp = ndp
        self.ranks = tuple(range(ndp) if ranks is None else ranks)
        self.dp_wire_dtype = dp_wire_dtype
        self.backend = backend

    # -- gathers -----------------------------------------------------------
    def _held_payload(self, x: torch.Tensor) -> torch.Tensor:
        """A held ``(local, ...)`` tensor as every run rank's payload: the
        same shards for each pod (one copy a pod on a cluster)."""
        L = len(self.ranks)
        if x.shape[0] == L:
            return x
        return x.repeat((L // x.shape[0],) + (1,) * (x.dim() - 1))

    def _gather(self, held: torch.Tensor, d: int) -> torch.Tensor:
        """``(local, *shard)`` blocks of dim ``d`` (of one rank's shard)
        -> every run rank's whole tensor ``(L, *shape)``, by all-gather."""
        x = self._held_payload(held).movedim(1 + d, 1)
        moved = tuple(x.shape[1:])
        out = self.comms.all_gather(_payload(x))
        out = out.reshape((out.shape[0], moved[0] * self.layout.nf)
                          + moved[1:])
        return out.movedim(1, 1 + d).contiguous()

    def gather_group(self, held: dict, g: int) -> list:
        """Group ``g``'s layer params, one tree a slot: a gathered leaf
        ``(L, ...)`` (rank ``r`` reads ``[r]``), a whole leaf's view of
        the group shared by every rank."""
        lay = self.layout
        per = lay.groups // lay.nf
        slots = [{} for _ in held["layers"]]
        for i, path, d in lay.group_leaves():
            x = _get(held["layers"][i], path)
            if d is None:
                v = x[g]
            elif d == 0:
                owner, j = divmod(g, per)
                p = self._held_payload(x[:, j])
                v = self.comms.broadcast(_payload(p), owner).reshape(
                    (p.shape[0],) + tuple(x.shape[2:]))
            else:
                v = self._gather(x[:, g], d - 1)
            _set(slots[i], path, v)
        return slots

    def gather_root(self, held: dict, name: str) -> torch.Tensor:
        d = self.layout.dims[name]
        return held[name] if d is None else self._gather(held[name], d)

    def _rank(self, tree, dims, k: int):
        """Rank ``k``'s (the ``k``-th run rank's) view of a gathered
        tree."""
        if isinstance(tree, dict):
            return {key: self._rank(tree[key], dims[key], k) for key in tree}
        return tree if dims is None else tree[k]

    def _slots(self, gathered: list, k: int) -> list:
        return [self._rank(s, self.layout.dims["layers"][i], k)
                for i, s in enumerate(gathered)]

    # -- the forward -------------------------------------------------------
    def rows(self, batch_rows: int) -> int:
        if batch_rows % self.ndp:
            raise ValueError(f"a batch of {batch_rows} rows does not split "
                             f"over {self.ndp} DP ranks")
        return batch_rows // self.ndp

    def _rank_rows(self, t: torch.Tensor, k: int) -> torch.Tensor:
        rows = self.rows(t.shape[0])
        r = self.ranks[k]
        return t[r * rows:(r + 1) * rows]

    def forward(self, held: dict, tokens: torch.Tensor, *,
                keep_inputs: bool = False):
        """Every run rank's last hidden state (before the final norm),
        groups in lock step, each gathered before it runs and dropped
        after; with ``keep_inputs`` also each group's input a rank."""
        cfg, lay = self.cfg, self.layout
        toks = [self._rank_rows(tokens, k) for k in range(len(self.ranks))]
        if tokens.is_floating_point():
            xs = [tf.embed_tokens({}, cfg, t) for t in toks]
        else:
            emb = self.gather_root(held, "embed")
            shared = lay.dims["embed"] is None
            xs = [tf.embed_tokens({"embed": emb if shared else emb[k]}, cfg,
                                  t) for k, t in enumerate(toks)]
            del emb
        cos, sin = tf.rope_tables(cfg, xs[0].shape[1], xs[0].device)
        inputs = [[] for _ in xs]
        for g in range(lay.groups):
            slots = self.gather_group(held, g)
            for k in range(len(xs)):
                if keep_inputs:
                    inputs[k].append(xs[k])
                xs[k] = tf.run_group(self._slots(slots, k), xs[k], cfg, cos,
                                     sin, self.backend)
            del slots
        return xs, inputs, (cos, sin), toks

    def _head_weight(self) -> str:
        return "embed" if self.cfg.tie_embeddings else "unembed"

    def prefill_logits(self, held: dict, tokens: torch.Tensor):
        """Last-position logits ``(b, vocab)`` f32 of the run ranks' rows,
        in rank order (the prefill step)."""
        xs, _, _, _ = self.forward(held, tokens)
        name = self._head_weight()
        w = self.gather_root(held, name)
        shared = self.layout.dims[name] is None
        out = []
        for k, x in enumerate(xs):
            p = {"ln_f": held["ln_f"], name: w if shared else w[k]}
            h = rms_norm(x[:, -1:], p["ln_f"], self.cfg.norm_eps)
            out.append(tf.logits_fn(p, self.cfg, h)[:, 0])
        return torch.cat(out)

    # -- the train step's gradients ----------------------------------------
    def _reduce(self, stacked: torch.Tensor, d: Optional[int]):
        """The run ranks' gradients ``(L, *shape)`` of one leaf (or one
        group of it) -> the held shards ``(local, *shard)`` (``d`` the
        sharded dim of ``shape``) or, for ``d=None``, the reduced whole
        (rank 0's copy); divided by the DP size, in the leaf's type."""
        dtype, L = stacked.dtype, stacked.shape[0]
        wire = self.dp_wire_dtype

        def cast(x):
            return x if wire is None else x.to(wire)

        if d is None:
            red = self.comms.all_reduce(cast(_payload(stacked)))
            return (red[0] / self.ndp).reshape(stacked.shape[1:]).to(dtype)
        x = stacked.movedim(1 + d, 1)
        moved = tuple(x.shape[1:])
        red = self.comms.reduce_scatter(cast(_payload(x)))
        lay = self.layout
        red = red[:lay.local].reshape(
            (min(lay.local, L), moved[0] // lay.nf) + moved[1:])
        return (red / self.ndp).movedim(1, 1 + d).to(dtype)

    def _head_rank(self, held, w, x, labels):
        """One rank's head: (loss, d hidden, d ln_f, d weight)."""
        name = self._head_weight()
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            ln = held["ln_f"].detach().requires_grad_()
            w = w.detach().requires_grad_()
            loss = tf.head_loss({"ln_f": ln, name: w}, self.cfg, x, labels)
            return (loss.detach(),) + torch.autograd.grad(loss, (x, ln, w))

    def _group_rank(self, slots, x, dy, cos, sin):
        """One rank's group recomputed under autograd: (d input, the
        group's leaf gradients in :meth:`FsdpLayout.group_leaves` order)."""
        ws = []
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            for i, path, _ in self.layout.group_leaves():
                leaf = _get(slots[i], path).detach().requires_grad_()
                _set(slots[i], path, leaf)
                ws.append(leaf)
            y = tf.run_group(slots, x, self.cfg, cos, sin, self.backend)
            got = torch.autograd.grad(y, [x] + ws, dy, allow_unused=True,
                                      materialize_grads=True)
        return got[0], got[1:]

    def _reduce_group(self, grads, whole, stacked, g):
        """Group ``g``'s stacked gradients into the held gradient tree
        (``whole`` gathers the whole leaves' groups for one reduction
        after the backward)."""
        lay = self.layout
        per = lay.groups // lay.nf
        for (i, path, d), st in zip(lay.group_leaves(), stacked):
            if d is None:
                acc = whole.get((i, path))
                if acc is None:
                    acc = whole[(i, path)] = torch.zeros(
                        (st.shape[0],) + tuple(_get(lay.meta["layers"][i],
                                                    path).shape),
                        dtype=st.dtype, device=st.device)
                acc[:, g] = st
            elif d == 0:
                owner, j = divmod(g, per)
                red = self.comms.all_reduce(self._wire(_payload(st)))
                if owner < lay.local:
                    _get(grads["layers"][i], path)[owner, j] = (
                        red[owner] / self.ndp).reshape(st.shape[1:]).to(
                            st.dtype)
            else:
                _get(grads["layers"][i], path)[:, g] = self._reduce(st, d - 1)

    def grads(self, held: dict, batch: dict):
        """(mean loss over the run ranks, the gradient as a held tree)."""
        cfg, lay = self.cfg, self.layout
        L = len(self.ranks)
        dev = held["ln_f"].device
        with torch.no_grad():
            xs, inputs, (cos, sin), toks = self.forward(
                held, batch["tokens"], keep_inputs=True)
        labels = [self._rank_rows(batch["labels"], k) for k in range(L)]
        grads = lay.empty(dev)
        root = {k: torch.zeros((L,) + tuple(lay.meta[k].shape),
                               dtype=lay.meta[k].dtype, device=dev)
                for k in ("embed", "ln_f", "unembed") if k in lay.dims}
        # -- the head: final norm, logits and loss, a rank at a time
        name = self._head_weight()
        w = self.gather_root(held, name)
        shared = lay.dims[name] is None
        losses, dxs = [], []
        for k in range(L):
            loss, dx, root["ln_f"][k], root[name][k] = self._head_rank(
                held, w if shared else w[k], xs[k], labels[k])
            losses.append(loss)
            dxs.append(dx)
            xs[k] = None
        del w
        # -- the groups, last first: gather again, recompute, reduce
        whole = {}
        for g in reversed(range(lay.groups)):
            slots = self.gather_group(held, g)
            stacked = [torch.empty(
                (L,) + tuple(_get(lay.meta["layers"][i], path).shape[1:]),
                dtype=_get(lay.meta["layers"][i], path).dtype, device=dev)
                for i, path, _ in lay.group_leaves()]
            for k in range(L):
                dxs[k], got = self._group_rank(self._slots(slots, k),
                                               inputs[k][g], dxs[k], cos, sin)
                inputs[k][g] = None
                for j, gw in enumerate(got):
                    stacked[j][k] = gw
                del got
            del slots
            self._reduce_group(grads, whole, stacked, g)
            del stacked
        # -- the lookup's gradient into the embedding, then the root leaves
        for k in range(L):
            if not toks[k].is_floating_point():
                root["embed"][k].index_put_((toks[k].long(),),
                                            dxs[k].to(root["embed"].dtype),
                                            accumulate=True)
            dxs[k] = None
        for key, st in root.items():
            grads[key] = self._reduce(st, lay.dims[key])
        for (i, path), acc in whole.items():
            _set(grads["layers"][i], path, self._reduce(acc, None))
        return torch.stack(losses).mean(), grads

    def _wire(self, x):
        return x if self.dp_wire_dtype is None else x.to(self.dp_wire_dtype)
