"""Expert-parallel MoE dispatch over the all_to_all (port of
``repro.distributed.moe_parallel``).

Tokens are routed to the ranks owning their experts with an all_to_all
(the paper's §2.1 headline collective for MoE), processed by the local
experts, and combined back with the inverse all_to_all. Dispatch and
combine move the same ``(e_total * capacity, d)`` buffer per rank, so
one plan serves both directions of every MoE layer.

Ranks are stacked on the leading axis (:mod:`repro_torch.mesh`): the
hidden state is ``(ep, b, s, d)`` — in explicit decode every rank holds
the same replicated batch and routes its own copy of it — and the
expert weights are ``(ep, e_local, d, f)``, rank ``r`` owning experts
``r*e_local ... (r+1)*e_local - 1``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.models.blocks import top_k

__all__ = ["moe_layer_ep", "ep_capacity"]


def ep_capacity(n_tok: int, top_k: int) -> int:
    """Per-(rank, expert) token capacity of the dispatch buffer, shared
    by the layer and the plan compiler
    (:func:`repro_torch.distributed.step.compile_decode_plans`). It is
    lossless: ``n_tok * top_k`` admits every assignment routed to one
    expert, so no token is dropped (the reference's
    ``capacity_factor=None``, what decode uses)."""
    return n_tok * top_k


def moe_layer_ep(p, x, cfg, *, comm=None, plan=None):
    """Sparse expert-parallel MoE on rank-stacked tensors.

    x: ``(ep, b, s, d)``; ``p["router"]`` ``(ep, d, e_total)``
    (replicated), ``p["w_gate"|"w_up"]`` ``(ep, e_local, d, f)`` and
    ``p["w_down"]`` ``(ep, e_local, f, d)`` (experts sharded whole).

    ``plan``: any callable ``plan(buf)`` on ``(ep, e_total*capacity, d)``
    buffers — a capacity-bucketed :class:`~repro_torch.core.comm.
    BucketedPlan`, an :class:`~repro_torch.core.comm.ExecutionPlan` or
    ``ops.all_to_all`` — replayed for both the dispatch and the combine.
    With ``plan=None`` the all_to_all goes through ``comm.all_to_all``
    (compile at first use, cache hits after). The capacity is lossless
    (:func:`ep_capacity`): every assignment gets a slot.

    Under a tracer's step (:mod:`repro_torch.core.spans`) the routing is
    marked ``moe.route`` (up to the dispatch, and the combine after the
    inverse all_to_all), the expert products ``moe.experts``, and where
    Python runs the step the expert rows computed and the choices a token
    makes are counted.
    """
    if plan is None and comm is None:
        raise ValueError("moe_layer_ep needs plan= (a compiled all_to_all) "
                         "or comm= (a Communicator of the expert axis)")
    ep, b, s, d = x.shape
    e_total = p["router"].shape[-1]
    e_local = e_total // ep
    k = cfg.moe.top_k
    n_tok = b * s
    capacity = ep_capacity(n_tok, k)
    dev = x.device
    ranks = torch.arange(ep, device=dev)[:, None]
    tokens = x.reshape(ep, n_tok, d)
    spans.count("moe.expert_rows", e_total * ep * capacity)
    spans.count("moe.choices", k)

    spans.mark("moe.route")
    router = torch.matmul(tokens, p["router"]).float()       # (ep, T, E)
    weights, idx = top_k(router, k)                          # (ep, T, k)
    weights = torch.softmax(weights, dim=-1)

    # ---- per-expert token slots (T·k assignments -> E × capacity) -------
    flat_expert = idx.reshape(ep, n_tok * k)
    flat_tok = torch.arange(n_tok, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(ep, n_tok * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_e = flat_expert.gather(-1, order)
    pos_in_e = torch.arange(n_tok * k, device=dev) - torch.searchsorted(
        sorted_e, sorted_e, right=False)
    slot = sorted_e * capacity + pos_in_e
    # dispatch buffer: row r holds the token routed to expert r//capacity
    # at slot r%capacity (zeros where unfilled)
    dispatch = torch.zeros((ep, e_total * capacity, d), dtype=x.dtype,
                           device=dev)
    dispatch[ranks, slot] = tokens[ranks, flat_tok[order]]

    def a2a(buf):
        return plan(buf) if plan is not None else comm.all_to_all(buf)

    # ---- all_to_all: expert-major blocks -> owning ranks ----------------
    spans.mark("moe.route")
    recv = a2a(dispatch)
    # recv[r]: from each of the ep senders, (e_local, capacity) rows for
    # rank r's experts; the products batch over (rank, local expert) so
    # the weights are read in place
    recv = recv.reshape(ep, ep, e_local, capacity, d).transpose(1, 2)
    recv = recv.reshape(ep, e_local, ep * capacity, d)
    spans.mark("moe.experts")
    h = torch.matmul(recv, p["w_gate"])
    u = torch.matmul(recv, p["w_up"])
    act = F.silu(h.float()).to(x.dtype) * u
    out = torch.matmul(act, p["w_down"])              # (ep, e_l, ep*c, d)
    spans.mark("moe.experts")
    out = out.reshape(ep, e_local, ep, capacity, d).transpose(1, 2)

    # ---- combine: inverse all_to_all + weighted sum in a fixed order ----
    back = a2a(out.reshape(ep, e_total * capacity, d))
    spans.mark("moe.route")
    # each assignment's slot back in assignment order (token, choice):
    # contributions are gathered, not scattered, and summed over the k
    # choices in order — no atomics, the same bits on every run
    slot_a = torch.empty_like(slot).scatter_(-1, order, slot)
    contrib = back[ranks, slot_a] * flat_w[..., None].to(x.dtype)
    contrib = contrib.reshape(ep, n_tok, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    spans.mark("moe.route")
    return y.reshape(ep, b, s, d)
