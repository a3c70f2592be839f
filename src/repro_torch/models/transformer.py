"""The LM behind one functional interface (port of
``repro.models.transformer``) for the dense, MoE, hybrid (attention+SSM),
rwkv6 and encoder families: seeded init, the full-sequence forward
(``forward``, whose attention core is the flash-attention kernel on the
card; ``remat_policy`` recomputes a group's layers in the backward), the
training loss (``loss_fn``, on the plain attention core that autograd
differentiates) and, for dense, MoE, hybrid and rwkv6, the decode cache
and the one-token decode step (a position shared by the batch or one a
row); for dense, MoE and hybrid also the cache-filling fused prefill
step — unsharded (auto) or on rank-stacked TP shards with the per-layer
collectives replayed through compiled plans (explicit; for MoE the same
axis carries expert parallelism, for hybrid the SSM branch is sharded on
its inner dim).

Parameter layout is the reference's: ``params["layers"]`` is a list
(length = period) of per-slot layer dicts whose leaves carry a leading
``groups`` axis, so weights carry across one to one. The explicit
layout (``distributed.sharding.explicit_decode_params``) puts a rank
axis in front of every leaf: ``wq`` ``(groups, d, nh, hd)`` becomes
``(tp, groups, d, nh/tp, hd)``. The encoder family (hubert) has a
forward and no decode, as in the reference's launcher: ``init_cache``
and ``decode_step`` raise for it. The rwkv6 family (``models/rwkv6.py``)
runs in auto mode only, as in the reference: its layers hold 21 leaves
of their own (no ``attn``), its cache is recurrent state alone, and the
explicit decode step and fused prefill raise for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.mesh import DeviceLike, resolve_device
from repro_torch.models import blocks, rwkv6, ssm
from repro_torch.models.blocks import rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "decode_step", "prefill_step",
           "forward", "loss_fn", "embed_tokens", "logits_fn", "rope_tables",
           "run_group", "head_loss", "cross_entropy",
           "layer_windows", "n_groups", "position_limit", "REMAT_POLICIES"]

FAMILIES = ("dense", "moe", "hybrid", "rwkv6", "encoder")
DECODE_FAMILIES = ("dense", "moe", "hybrid", "rwkv6")
#: the families with a fused prefill step and an explicit decode step
PREFILL_FAMILIES = EXPLICIT_FAMILIES = ("dense", "moe", "hybrid")


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


def position_limit(cfg: ModelConfig, max_kv: int) -> int:
    """The first position a decode step may not present: ``cfg.max_seq``
    (the model's context, RoPE's table) or, with a global attention
    layer, its cache length ``max_kv`` if smaller (a windowed layer's
    ring wraps). The rwkv6 family keeps no KV, so only ``max_seq``."""
    if cfg.family != "rwkv6" and None in layer_windows(cfg):
        return min(cfg.max_seq, max_kv)
    return cfg.max_seq


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None, seed: int = 0) -> dict:
    """Seeded random weights on ``device`` (default: the CUDA card;
    ``"meta"`` gives the shapes and types alone).
    The numbers differ from the reference's ``jax.random`` ones; to hold
    the two against each other, carry the reference's weights across
    with :func:`repro_torch.interop.params_from_jax`."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator
    if gen is None and device.type != "meta":
        # on ``meta`` (shapes alone: the dry run) nothing is drawn
        gen = torch.Generator(device=device).manual_seed(seed)
    d, dt = cfg.d_model, cfg.tdtype
    lead = (n_groups(cfg),)
    if cfg.family == "rwkv6":
        slots = [rwkv6.init_rwkv_layer(gen, cfg, lead=lead, device=device)]
    else:
        slots = [_init_slot(gen, cfg, lead, device)
                 for _ in layer_windows(cfg)]
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


def _init_slot(gen, cfg: ModelConfig, lead, device) -> dict:
    """One period slot's layer params of an attention family."""
    d, dt = cfg.d_model, cfg.tdtype
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
    return slot


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
    ``explicit_decode_cache_pspecs``).

    The rwkv6 family's cache is its recurrent state alone, in f32, each
    leaf with a leading groups axis, one slot a name: ``{"wkv":
    [(groups, b, nh, 64, 64)], "shift_t": [(groups, b, d)], "shift_c":
    [(groups, b, d)]}``. ``max_kv`` and ``dtype`` do not apply to it (an
    int8 cache leaves it in f32, as in the reference), and it has no
    explicit layout (``ranks``)."""
    _check_family(cfg, DECODE_FAMILIES)
    device = resolve_device(device)
    if cfg.family == "rwkv6":
        if ranks:
            raise NotImplementedError(
                "the rwkv6 family has no explicit (rank-stacked) cache: it "
                "stays on auto")
        state = rwkv6.init_rwkv_state(cfg, batch, device=device)
        return {name: [leaf.new_zeros((n_groups(cfg),) + tuple(leaf.shape))]
                for name, leaf in state.items()}
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
    if cfg.family == "rwkv6":
        # a fresh state a call; the channel mix gets the state the time
        # mix returns
        state = rwkv6.init_rwkv_state(cfg, x.shape[0], device=x.device)
        return rwkv6.rwkv_decode_step(p, x, state, cfg)[0]
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


REMAT_POLICIES = ("none", "full")


def forward(params, cfg: ModelConfig, tokens, *,
            backend: Optional[str] = None, remat_policy: str = "none"):
    """tokens: (b, s) int — or (b, s, d) float embeddings for frontend
    archs -> the final hidden states (b, s, d), normed. Every layer's
    attention core is one flash-attention kernel launch on the card;
    ``backend="torch"`` runs the plain core instead (``"cuda"`` insists
    on the kernel). Groups are walked as ``decode_step`` walks them.

    ``remat_policy="full"`` wraps each group's layers in
    ``torch.utils.checkpoint.checkpoint`` (as the reference wraps its scan
    body in ``jax.checkpoint``): under autograd a group keeps only its
    input and recomputes the rest in the backward."""
    _check_family(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {remat_policy!r}")
    x = embed_tokens(params, cfg, tokens)
    cos, sin = rope_tables(cfg, x.shape[1], x.device)
    wins = layer_windows(cfg)
    slots = [_per_group(params["layers"][i]) for i in range(len(wins))]

    def body(x, g):
        return run_group([slot[g] for slot in slots], x, cfg, cos, sin,
                         backend)

    for g in range(n_groups(cfg)):
        if remat_policy == "full":
            x = torch.utils.checkpoint.checkpoint(body, x, g,
                                                  use_reentrant=False)
        else:
            x = body(x, g)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def rope_tables(cfg: ModelConfig, s: int, device):
    """(cos, sin) of positions ``0..s-1`` for :func:`run_group`, made on
    the device and read there (a host tensor's copy would wait for the
    stream, once a forward); ``(None, None)`` for rwkv6, which has no
    positions."""
    if s > cfg.max_seq:
        raise ValueError(f"forward(): {s} positions > max_pos {cfg.max_seq}")
    if cfg.family == "rwkv6":
        return None, None
    return blocks.rope(torch.arange(s, device=device), cfg.hd,
                       cfg.rope_theta, device, max_pos=s, on_device=True)


def run_group(slots: list, x, cfg: ModelConfig, cos, sin,
              backend: Optional[str] = None):
    """One layer group of :func:`forward` on ``x`` (b, s, d): ``slots``
    holds the group's layer params, one dict a period slot (no
    ``groups`` axis)."""
    for p, win in zip(slots, layer_windows(cfg)):
        x = _run_layer(p, x, cfg, win, cos, sin, backend)
    return x


def _per_group(tree) -> list:
    """The layer params of every group: each leaf unbound along its
    leading ``groups`` axis into views. Under autograd that is one
    backward node a leaf, which stacks the groups' gradients once (a view
    of one group a layer would fill a zero tensor of the whole leaf per
    layer)."""
    if isinstance(tree, dict):
        parts = {k: _per_group(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def logits_fn(params, cfg: ModelConfig, hidden):
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["unembed"]
    return torch.einsum("...bsd,...dv->...bsv", hidden, w).float()


def loss_fn(params, cfg: ModelConfig, batch, *, remat_policy: str = "none",
            attn_backend: str = "torch"):
    """batch: dict(tokens (b, s) [or (b, s, d) frames], labels (b, s)) ->
    the mean next-token cross entropy, a 0-d f32 tensor (the reference's:
    a max-shifted logsumexp, the max held constant, minus the gold logit).

    The gold logit is a ``gather``, which in f32 equals the reference's
    one-hot einsum and spares the ``(b, s, vocab)`` one-hot. The attention
    core is named here: ``attn_backend="torch"`` is the port of the
    reference's pure core (``blocks._plain_core``/``_chunked_attn``, torch
    ops that autograd differentiates), which training needs: the
    flash-attention kernel (``"cuda"``) has no backward and refuses inputs
    that need a gradient."""
    hidden = forward(params, cfg, batch["tokens"], backend=attn_backend,
                     remat_policy=remat_policy)
    return cross_entropy(logits_fn(params, cfg, hidden), batch["labels"])


def head_loss(params, cfg: ModelConfig, x, labels):
    """:func:`loss_fn` from the last group's output ``x`` on: the final
    norm, the logits and the cross entropy (``params`` needs ``ln_f`` and
    the logits' weight alone)."""
    hidden = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return cross_entropy(logits_fn(params, cfg, hidden), labels)


def cross_entropy(logits, labels):
    """Mean next-token cross entropy of f32 ``logits``, as
    :func:`loss_fn` computes it."""
    labels = labels.to(logits.device).long()
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (logz - gold).mean()


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
    the hybrid family's SSM branch. Returns ``x`` and the SSM write-backs
    ``[(state, new_state), ...]``, which the caller applies
    (:func:`_write_back`) after its step's last executor call: a step
    that raises part-way leaves the recurrent state as it found it, so
    its re-run reads what the first attempt read (the KV writes are
    idempotent: a re-run writes the same entries before it reads them).
    See :func:`decode_step` for ``comms``."""
    ranked = comms is not None
    writes = []
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
                writes.append((state, s_new))
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
    return x, writes


def _write_back(writes) -> None:
    for state, new in writes:
        state.copy_(new)


def _check_explicit(cfg: ModelConfig, comms) -> None:
    if comms is None:
        return
    if cfg.family not in EXPLICIT_FAMILIES:
        raise NotImplementedError(
            "explicit decode covers the dense, hybrid (attention+SSM) and "
            "MoE families — fp and int8 KV caches alike; rwkv6 and encoder "
            "configs stay on auto")
    if cfg.family == "moe" and comms.moe_plan is None:
        raise NotImplementedError(
            "explicit MoE decode needs a compiled 'moe_alltoall' plan "
            "(experts divisible by the TP axis); without one the family "
            "stays on auto")


def _rwkv_decode(params, cfg: ModelConfig, cache, tokens, active):
    """The rwkv6 family's decode step (auto): each group's layer from its
    recurrent state; an inactive row's state passes through bit for bit;
    the new state is written back after the logits."""
    x = params["embed"][tokens][:, None]                  # (b, 1, d)
    layers = params["layers"][0]
    writes = []
    for g in range(n_groups(cfg)):
        state = {name: cache[name][0][g] for name in rwkv6.STATE_NAMES}
        x, new = rwkv6.rwkv_decode_step(_group(layers, g, False), x, state,
                                        cfg)
        for name, old in state.items():
            upd = new[name]
            if active is not None:
                keep = active.reshape((-1,) + (1,) * (old.dim() - 1))
                upd = torch.where(keep, upd, old)
            writes.append((old, upd))
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_fn(params, cfg, h)[:, 0]
    _write_back(writes)
    return logits, cache


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
    convention. The SSM state is written last, after the logits gather,
    so a step that raises part-way can be re-run from where it started.

    The rwkv6 family is position-free: ``pos`` is not read (no cache
    length to check), each layer runs ``rwkv6.rwkv_decode_step`` on its
    recurrent state, which an ``active`` mask passes through for an
    inactive row and which is written back after the logits, as the SSM
    state is. It has no explicit step.

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
    _check_explicit(cfg, comms)
    if cfg.family == "rwkv6":
        return _rwkv_decode(params, cfg, cache, tokens, active)
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

    x, writes = _cached_layers(params, cfg, cache, x, comms, attend,
                               ssm_step)
    h = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (comms.logits(params, h) if ranked
              else logits_fn(params, cfg, h)[:, 0])
    _write_back(writes)
    return logits, cache


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
    if cfg.family not in PREFILL_FAMILIES:
        raise NotImplementedError(
            f"fused prefill covers the dense, MoE and hybrid families; "
            f"{cfg.family!r} has none (rwkv6 prefills token by token "
            f"through the decode step)")
    _check_explicit(cfg, comms)
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

    _write_back(_cached_layers(params, cfg, cache, x, comms, attend,
                               ssm_step)[1])
    return cache
