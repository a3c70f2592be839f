"""The LM behind one functional interface (port of
``repro.models.transformer``) for the dense, MoE, hybrid (attention+SSM)
and encoder families: seeded init, the full-sequence forward
(``forward``, whose attention core is the flash-attention kernel on the
card) and, for dense, MoE and hybrid, the decode cache, the one-token
decode step (a position shared by the batch or one a row) and the
cache-filling fused prefill step — unsharded (auto) or on rank-stacked TP shards with the
per-layer collectives replayed through compiled plans (explicit; for MoE
the same axis carries expert parallelism, for hybrid the SSM branch is
sharded on its inner dim).

Parameter layout is the reference's: ``params["layers"]`` is a list
(length = period) of per-slot layer dicts whose leaves carry a leading
``groups`` axis, so weights carry across one to one. The explicit
layout (``distributed.sharding.explicit_decode_params``) puts a rank
axis in front of every leaf: ``wq`` ``(groups, d, nh, hd)`` becomes
``(tp, groups, d, nh/tp, hd)``. The encoder family (hubert) has a
forward and no decode, as in the reference's launcher: ``init_cache``
and ``decode_step`` raise for it. The rwkv6 family raises
``NotImplementedError`` everywhere.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.mesh import DeviceLike, resolve_device
from repro_torch.models import blocks, ssm
from repro_torch.models.blocks import rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "decode_step", "prefill_step",
           "forward", "embed_tokens", "logits_fn", "layer_windows",
           "n_groups"]

FAMILIES = ("dense", "moe", "hybrid", "encoder")
DECODE_FAMILIES = ("dense", "moe", "hybrid")


def _check_family(cfg: ModelConfig, families=FAMILIES) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported for this path; it covers "
            f"{families}")


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Attention window per layer within one period group."""
    per = cfg.local_global_period
    if per > 1:
        return [cfg.window] * (per - 1) + [None]
    return [cfg.window]


def n_groups(cfg: ModelConfig) -> int:
    per = cfg.local_global_period
    assert cfg.n_layers % per == 0, (cfg.n_layers, per)
    return cfg.n_layers // per


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None, seed: int = 0) -> dict:
    """Seeded random weights on ``device`` (default: the CUDA card).
    The numbers differ from the reference's ``jax.random`` ones; to hold
    the two against each other, carry the reference's weights across
    with :func:`repro_torch.interop.params_from_jax`."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    groups = n_groups(cfg)
    d, dt = cfg.d_model, cfg.tdtype
    lead = (groups,)
    slots = []
    for _ in layer_windows(cfg):
        slot = {
            "ln_attn": torch.zeros(lead + (d,), dtype=dt, device=device),
            "ln_mlp": torch.zeros(lead + (d,), dtype=dt, device=device),
            "attn": blocks.init_attn(gen, cfg, lead=lead, device=device),
        }
        if cfg.family == "moe":
            slot["moe"] = blocks.init_moe(gen, cfg, lead=lead, device=device)
        else:
            slot["mlp"] = blocks.init_mlp(gen, cfg, lead=lead, device=device)
        if cfg.family == "hybrid":
            # parallel SSM heads beside attention (Hymba); outputs averaged
            slot["ssm"] = ssm.init_ssm_head(gen, cfg, d, lead=lead,
                                            device=device)
        slots.append(slot)
    params = {
        "embed": blocks.init_linear(gen, (cfg.vocab, d), dt, scale=1.0,
                                    device=device),
        "ln_f": torch.zeros((d,), dtype=dt, device=device),
        "layers": slots,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = blocks.init_linear(gen, (d, cfg.vocab), dt,
                                               device=device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_kv: int, *,
               device: DeviceLike = None, dtype=None,
               ranks: Optional[int] = None) -> dict:
    """Decode cache: per period slot, ``(groups, b, kv_heads, kv_i, hd)``
    with ``kv_i = min(window, max_kv)`` for windowed slots. ``ranks``
    adds a leading rank axis: the explicit-TP cache is replicated, every
    rank holding every KV head.

    ``dtype=torch.int8`` is the int8 KV cache: ``k_scale``/``v_scale``
    entries hold each token's per-(batch, head) scale, ``(groups, b,
    kv_heads, kv_i, 1)`` in bf16 as in the reference (replicated over
    ``ranks`` like the cache).

    The hybrid family adds ``ssm``: one f32 state ``(groups, b,
    d_model, state)`` a slot. Under ``ranks`` it is rank-sharded on its
    inner dim, ``(ranks, groups, b, d_model / ranks, state)``: each
    rank updates only its rows (the reference's
    ``explicit_decode_cache_pspecs``)."""
    _check_family(cfg, DECODE_FAMILIES)
    device = resolve_device(device)
    dtype = dtype or cfg.tdtype
    _, nkv = blocks.padded_heads(cfg)
    lead = (ranks,) if ranks else ()

    def kv(win, last=cfg.hd, dt=dtype):
        size = min(win, max_kv) if win is not None else max_kv
        return torch.zeros(lead + (n_groups(cfg), batch, nkv, size, last),
                           dtype=dt, device=device)

    wins = layer_windows(cfg)
    cache = {"k": [kv(w) for w in wins], "v": [kv(w) for w in wins]}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = [kv(w, 1, torch.bfloat16) for w in wins]
    if cfg.family == "hybrid":
        rows = cfg.d_model // ranks if ranks else cfg.d_model
        cache["ssm"] = [torch.zeros(lead + (n_groups(cfg), batch, rows,
                                            cfg.ssm.state_dim),
                                    dtype=torch.float32, device=device)
                        for _ in wins]
    return cache


def _run_layer(p, x, cfg: ModelConfig, win, cos, sin, backend):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    att = blocks.attention(p["attn"], h, cfg, cos, sin, window=win,
                           backend=backend)
    if cfg.family == "hybrid":
        s_out, _ = ssm.ssm_forward(p["ssm"], h, cfg)
        att = (att + s_out) * 0.5
    x = x + att
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.family == "moe":
        return x + blocks.moe_layer(p["moe"], h, cfg)
    return x + blocks.mlp_swiglu(p["mlp"], h)


def embed_tokens(params, cfg: ModelConfig, tokens):
    """Integer tokens -> embedding lookup; float inputs are precomputed
    frontend embeddings (audio frames, vision patches) and pass through
    in the model dtype."""
    if tokens.is_floating_point():
        return tokens.to(cfg.tdtype)
    return params["embed"][tokens.long()]


def forward(params, cfg: ModelConfig, tokens, *,
            backend: Optional[str] = None):
    """tokens: (b, s) int — or (b, s, d) float embeddings for frontend
    archs -> the final hidden states (b, s, d), normed. Every layer's
    attention core is one flash-attention kernel launch on the card;
    ``backend="torch"`` runs the plain core instead (``"cuda"`` insists
    on the kernel). Groups are walked as ``decode_step`` walks them."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    cos, sin = blocks.rope(torch.arange(x.shape[1]), cfg.hd, cfg.rope_theta,
                           x.device, max_pos=cfg.max_seq)
    wins = layer_windows(cfg)
    for g in range(n_groups(cfg)):
        for i, win in enumerate(wins):
            x = _run_layer(_group(params["layers"][i], g, False), x, cfg,
                           win, cos, sin, backend)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["unembed"]
    return torch.einsum("...bsd,...dv->...bsv", hidden, w).float()


def _group(tree, g: int, ranked: bool):
    """Layer params of group ``g`` (views; rank axis first if ranked)."""
    if isinstance(tree, dict):
        return {k: _group(v, g, ranked) for k, v in tree.items()}
    return tree[:, g] if ranked else tree[g]


def _cached_layers(params, cfg: ModelConfig, cache, x, comms, attend,
                   ssm_step):
    """The layer loop of :func:`decode_step` and :func:`prefill_step` on
    ``x`` (…, b, s, d): ``attend(p, h, cache_k, cache_v, window,
    head_offset, k_scale, v_scale)`` is the layer's cache-writing
    attention, ``ssm_step(p, h, state, d_offset) -> (out, new_state)``
    the hybrid family's SSM branch, whose state is written back with
    ``copy_``. See :func:`decode_step` for ``comms``."""
    ranked = comms is not None
    for g in range(n_groups(cfg)):
        for i, win in enumerate(layer_windows(cfg)):
            lp = _group(params["layers"][i], g, ranked)
            ck, cv, ks, vs = (
                (_group(cache[name][i], g, ranked) if name in cache
                 else None)
                for name in ("k", "v", "k_scale", "v_scale"))
            h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
            ho = (comms.head_offset(lp["attn"]["wq"].shape[-2])
                  if ranked else None)
            att = attend(lp["attn"], h, ck, cv, win, ho, ks, vs)
            if cfg.family == "hybrid":
                state = _group(cache["ssm"][i], g, ranked)
                d_off = (comms.ssm_offset(lp["ssm"]["a_log"].shape[-2])
                         if ranked else None)
                s_out, s_new = ssm_step(lp["ssm"], h, state, d_off)
                state.copy_(s_new)
                if ranked:
                    # its own replay, as in the reference: attention and
                    # SSM partials complete apart, then average
                    s_out = comms.hidden(s_out)
            if ranked:
                att = comms.hidden(att)     # complete the out-proj partial
            if cfg.family == "hybrid":
                att = (att + s_out) * 0.5
            x = x + att
            h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
            if cfg.family == "moe":
                mlp_out = (comms.moe(lp["moe"], h) if ranked
                           else blocks.moe_layer(lp["moe"], h, cfg))
            else:
                mlp_out = blocks.mlp_swiglu(lp["mlp"], h)
                if ranked:
                    mlp_out = comms.hidden(mlp_out)   # down-proj partial
            x = x + mlp_out
    return x


def _check_explicit_moe(cfg: ModelConfig, comms) -> None:
    if comms is not None and cfg.family == "moe" and comms.moe_plan is None:
        raise NotImplementedError(
            "explicit MoE decode needs a compiled 'moe_alltoall' plan "
            "(experts divisible by the TP axis); without one the family "
            "stays on auto")


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *, comms=None,
                active=None):
    """tokens: (b,) int; pos: the position the batch shares, an int or a
    0-d integer tensor, or a ``(b,)`` integer tensor of per-row
    positions (the scheduler's slots). An int is checked on the host
    (below ``cfg.max_seq`` and a global layer's cache length) and becomes
    a 0-d tensor; a tensor is read on the device only, so the step holds
    no host read and a CUDA graph captures it whole, and the caller keeps
    it in range. ``active`` (with per-row positions): a ``(b,)`` bool
    tensor; an inactive row's cache row and SSM state pass through the
    step bit for bit (its logits row is computed and meaningless).
    Returns (logits (b, vocab) f32, cache) — the cache (with an int8
    cache its ``k_scale``/``v_scale`` too, for the hybrid family its SSM
    state) is updated in place and returned for the reference's calling
    convention.

    ``comms`` — the explicit-TP hook (``distributed.step.TPDecodeComms``):
    params and cache arrive rank-stacked, the per-layer hidden-state
    partials (attention out-proj, MLP down-proj, and the hybrid family's
    SSM out-proj) are completed by ``comms.hidden`` (a replay of the
    compiled AllReduce plan), the
    vocab-sharded embedding lookup and the logits go through
    ``comms.embed`` / ``comms.logits``, and attention receives every
    shard's global head offset. A MoE layer runs ``comms.moe`` —
    expert-parallel dispatch and combine through the compiled
    capacity-bucketed all_to_all plan, whose output is complete on
    every rank, so no AllReduce follows it — where the auto path runs
    the dense oracle ``blocks.moe_layer``. A hybrid layer runs its SSM
    branch on the rank's ``d_inner`` rows (``comms.ssm_offset``; the
    state arrives rank-sharded) and completes its out-proj partial with
    its own replay of the AllReduce plan before averaging it with
    attention's, so an explicit hybrid layer makes 3 replays.
    ``comms=None`` is the auto path.
    """
    _check_family(cfg, DECODE_FAMILIES)
    _check_explicit_moe(cfg, comms)
    if not isinstance(pos, torch.Tensor):
        wins = layer_windows(cfg)
        limit = min([cfg.max_seq] + [c.shape[-2] for c, w
                                     in zip(cache["k"], wins) if w is None])
        pos = blocks.device_position(pos, limit, tokens.device)
    ranked = comms is not None
    if ranked:
        x = comms.embed(params["embed"], tokens)[..., None, :]
    else:
        x = params["embed"][tokens][:, None]              # (b, 1, d)

    def attend(p, h, ck, cv, win, ho, ks, vs):
        return blocks.decode_attention(p, h, ck, cv, pos, cfg, window=win,
                                       head_offset=ho, k_scale=ks,
                                       v_scale=vs, active=active)

    def ssm_step(p, h, state, d_off):
        out, new = ssm.ssm_decode_step(p, h, state, cfg, d_offset=d_off)
        if active is not None:
            new = torch.where(active[:, None, None], new, state)
        return out, new

    x = _cached_layers(params, cfg, cache, x, comms, attend, ssm_step)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if ranked:
        return comms.logits(params, h), cache
    return logits_fn(params, cfg, h)[:, 0], cache


def prefill_step(params, cfg: ModelConfig, cache, tokens, pos, n_tok, *,
                 comms=None):
    """Fused prefill: advance every row's cache by a prompt chunk in one
    step, as :func:`decode_step` would one token at a time (the port of
    the reference's ``prefill_step``).

    tokens: (b, S) int — each row's next chunk, left-aligned (padding
    past a row's count is any token); pos: (b,) the position of each
    row's first chunk token; n_tok: (b,) how many of the S tokens are
    real (0: the row's cache and SSM state pass through bit for bit).
    ``pos`` and ``n_tok`` are device tensors, read on the device only.
    Returns the cache, updated in place; no logits (the scheduler runs a
    row's last prompt token through the decode step). ``comms`` is the
    explicit-TP hook, as in :func:`decode_step`: every partial completes
    through the AllReduce plan at ``b·S`` rows. On windowed layers each
    row needs ``n_tok == 1`` or ``pos + n_tok <= kv_len``
    (:func:`blocks.prefill_attention`). The rwkv6 and encoder families
    have no fused prefill."""
    if cfg.family not in DECODE_FAMILIES:
        raise NotImplementedError(
            f"fused prefill covers the dense, MoE and hybrid families; "
            f"{cfg.family!r} has none")
    _check_explicit_moe(cfg, comms)
    b, S = tokens.shape
    if comms is not None:
        x = comms.embed(params["embed"], tokens.reshape(-1)).unflatten(
            -2, (b, S))
    else:
        x = params["embed"][tokens]                       # (b, S, d)

    def attend(p, h, ck, cv, win, ho, ks, vs):
        return blocks.prefill_attention(p, h, ck, cv, pos, n_tok, cfg,
                                        window=win, head_offset=ho,
                                        k_scale=ks, v_scale=vs)

    def ssm_step(p, h, state, d_off):
        return ssm.ssm_prefill_scan(p, h, state, cfg, n_tok, d_offset=d_off)

    _cached_layers(params, cfg, cache, x, comms, attend, ssm_step)
    return cache
