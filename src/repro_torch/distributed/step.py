"""Explicit tensor-parallel decode (paper §5.2: compiled plans on the
token hot path) — port of ``repro.distributed.step``'s serving half.

* :func:`compile_decode_plans` compiles, once, the per-layer hidden
  AllReduce (``layer_allreduce``, also the vocab-sharded embedding's
  gather-reduce), the vocab-sharded ``logits_allgather``, bucketed over
  active-slot counts, and for MoE the expert-parallel ``moe_alltoall``,
  bucketed over per-rank token capacities; with ``seq_buckets`` the
  ladders also hold the ``b·S`` rows of a fused prefill step
  (:func:`seq_bucket_rows`);
* :class:`TPDecodeComms` replays them inside ``decode_step(comms=)``
  and ``prefill_step(comms=)``;
* :func:`make_serve_step` builds the one-token step in ``auto`` mode
  (the unsharded model on one device) or ``explicit`` mode (rank-stacked
  shards, every collective a plan replay), on a bf16/f32 or an int8 KV
  cache;
* :func:`make_sched_step` builds the scheduler's step: per-row positions
  and an ``active`` mask; :func:`make_prefill_sched_step` its fused
  prefill micro-step over a ``(b, S)`` chunk;
* :func:`capture_serve_step` and :func:`capture_sched_step` capture a
  step once in a CUDA graph and replay it every token — the port's
  counterpart of the reference's ``jax.jit`` step;
* :func:`make_prefill_step` builds the full-sequence prefill forward
  (what a prompt costs before its first token) in auto mode: one
  unsharded model, each layer's attention core one flash-attention
  launch on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import comm as comm_lib
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.moe_parallel import ep_capacity, moe_layer_ep
from repro_torch.mesh import DeviceLike, RankAxis, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

__all__ = ["local_batch", "slot_buckets", "seq_bucket_rows",
           "compile_decode_plans", "TPDecodeComms", "make_serve_step",
           "make_sched_step", "make_prefill_sched_step", "cache_rows",
           "capture_serve_step", "capture_sched_step", "CapturedStep",
           "CapturedSchedStep", "CaptureError", "make_prefill_step",
           "StepLayout"]


def local_batch(axis: RankAxis, batch: int) -> tuple[int, bool]:
    """(rows a replica's step holds, whether the batch is DP-sharded):
    ``(batch, False)`` always — the port stacks one replica's TP ranks
    on one card and has no data-parallel axis inside a replica
    (replicas are the router's)."""
    return int(batch), False


def slot_buckets(batch_local: int) -> tuple[int, ...]:
    """Active-slot bucket ladder: powers of two up to (and always
    including) the full local batch."""
    out, k = [], 1
    while k < batch_local:
        out.append(k)
        k *= 2
    out.append(batch_local)
    return tuple(out)


def seq_bucket_rows(batch_local: int, buckets, seq_buckets) -> tuple:
    """The merged row ladder of a sequence-bucketed plan family: the
    slot buckets plus ``batch_local * s`` for each prefill sequence
    bucket ``s`` (a smaller ``b · S`` pads up to the next bucket)."""
    rows = set(buckets)
    for s in (seq_buckets or ()):
        if s < 1:
            raise ValueError(f"sequence buckets must be >= 1, got {s}")
        rows.add(batch_local * int(s))
    return tuple(sorted(rows))


def compile_decode_plans(cfg: ModelConfig, comm, *, batch_local: int,
                         tp: int, buckets=None, seq_buckets=None) -> dict:
    """The decode-step collective plans, compiled once and replayed every
    generated token: ``layer_allreduce`` over ``(rows, d_model)`` in the
    model dtype (a hybrid layer replays it for its SSM partial too);
    when the vocab divides the TP axis, ``logits_allgather`` over
    ``(rows, vocab/tp)`` in float32; and for the MoE family with experts
    divisible by the axis, ``moe_alltoall`` — the dispatch and combine
    all_to_all over ``(tp * rows, d_model)``, bucketed over the rows per
    per-rank block ``e_local * ep_capacity(b)`` of each row bucket ``b``
    (lossless capacity, so nothing drops).

    ``seq_buckets``: the prompt-chunk lengths of fused prefill. Each adds
    a ``batch_local * s`` row bucket to ``layer_allreduce`` (and its
    capacity to ``moe_alltoall``), so a prefill micro-step replays the
    same plan families at a larger bucket; ``logits_allgather`` needs
    none (fused prefill makes no logits)."""
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"decode plans for family {cfg.family!r} are not ported")
    buckets = tuple(buckets) if buckets else slot_buckets(batch_local)
    rows = seq_bucket_rows(batch_local, buckets, seq_buckets)
    plans = {"layer_allreduce": comm.plan_for(
        "all_reduce", (batch_local, cfg.d_model), cfg.dtype,
        buckets=rows)}
    if cfg.vocab % tp == 0:
        plans["logits_allgather"] = comm.plan_for(
            "all_gather", (batch_local, cfg.vocab // tp), "float32",
            buckets=buckets)
    if cfg.family == "moe" and cfg.moe.num_experts % tp == 0:
        e_local = cfg.moe.num_experts // tp
        caps = tuple(sorted({e_local * ep_capacity(b, cfg.moe.top_k)
                             for b in rows}))
        plans["moe_alltoall"] = comm.plan_for(
            "all_to_all", (tp * caps[-1], cfg.d_model), cfg.dtype,
            buckets=caps)
    return plans


class TPDecodeComms:
    """The per-layer TP communication hook that the explicit step hands
    to ``transformer.decode_step``. Every method is pure plan replay on
    rank-stacked tensors: the plans were compiled before the first
    token. For the MoE family the same axis doubles as the
    expert-parallel axis: ``moe_plan`` is the capacity-bucketed
    dispatch/combine all_to_all and :meth:`moe` runs the sparse layer
    through it."""

    def __init__(self, cfg: ModelConfig, axis: RankAxis, *, hidden_plan,
                 logits_plan=None, moe_plan=None):
        self.cfg = cfg
        self.axis = axis
        self.tp = axis.n
        self.hidden_plan = hidden_plan      # bucketed all_reduce (b, d_model)
        self.logits_plan = logits_plan      # bucketed all_gather or None
        self.moe_plan = moe_plan            # bucketed EP all_to_all or None
        self.vocab_sharded = logits_plan is not None
        self._ranks = axis.index()

    def head_offset(self, nh_local: int) -> torch.Tensor:
        """(tp,) global index of every shard's first query head."""
        return self._ranks * nh_local

    def ssm_offset(self, d_local: int) -> torch.Tensor:
        """(tp,) global index of every shard's first SSM ``d_inner`` row
        (hybrid family): the SSM branch runs its recurrence on
        ``d_local`` rows from there, and :meth:`hidden` completes its
        out-proj partial."""
        return self._ranks * d_local

    def moe(self, lp, x):
        """Expert-parallel MoE layer on a rank-stacked (tp, b, s,
        d_model) hidden state: dispatch and combine replay the
        capacity-bucketed all_to_all plan, at lossless capacity, so no
        token drops on the decode path."""
        return moe_layer_ep(lp, x, self.cfg, plan=self.moe_plan)

    def hidden(self, x):
        """AllReduce a rank-stacked (tp, b, s, d_model) partial."""
        tp, b, s, d = x.shape
        return self.hidden_plan(x.reshape(tp, b * s, d)).reshape(tp, b, s, d)

    def embed(self, table, tokens):
        """Lookup on the (tp, vocab/tp, d) sharded table: out-of-shard
        tokens read zero rows, then the AllReduce plan completes the
        gather (zero rows are exact under the sum)."""
        if not self.vocab_sharded:
            return table[:, tokens]
        vloc = table.shape[1]
        idx = tokens[None, :] - (self._ranks * vloc)[:, None]   # (tp, b)
        ok = (idx >= 0) & (idx < vloc)
        rows = table[self._ranks[:, None], idx.clamp(0, vloc - 1)]
        x = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
        return self.hidden_plan(x)

    def logits(self, params, hidden):
        """(tp, b, 1, d_model) hidden -> (b, vocab) f32 logits, the
        vocab-sharded columns gathered through the AllGather plan. Every
        rank ends with the same logits; rank 0's are returned."""
        w = params["embed"].transpose(-1, -2) if self.cfg.tie_embeddings \
            else params["unembed"]
        local = torch.einsum("rbsd,rdv->rbsv", hidden, w).float()[:, :, 0]
        if not self.vocab_sharded:
            return local[0]
        tp, b, vloc = local.shape
        g = self.logits_plan(local)                     # (tp, tp*b, vloc)
        return g.reshape(tp, tp, b, vloc)[0].transpose(0, 1).reshape(
            b, tp * vloc)


class StepLayout(NamedTuple):
    """How a step's inputs are laid out: ``params(p)`` turns reference-
    layout params into the step's layout on its device, ``cache()``
    makes an empty decode cache for it."""

    params: Callable[[dict], dict]
    cache: Callable[[], dict]


def _on(params, device):
    if isinstance(params, dict):
        return {k: _on(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_on(v, device) for v in params]
    return params.to(device)


def _step_comms(cfg: ModelConfig, axis: RankAxis, *, batch: int,
                max_kv: int, mode: str, comm, plans, kv_quant: bool,
                seq_buckets=None):
    """(comms, layout) of a step: ``comms`` is ``None`` in auto mode and
    the :class:`TPDecodeComms` over ``plans`` (compiled here on ``comm``
    — by default a new :class:`~repro_torch.core.comm.Communicator` with
    the device's backend — when omitted) in explicit mode."""
    dtype = torch.int8 if kv_quant else None
    if mode == "auto":
        return None, StepLayout(
            params=lambda p: _on(p, axis.device),
            cache=lambda: tf.init_cache(cfg, batch, max_kv,
                                        device=axis.device, dtype=dtype))
    if mode != "explicit":
        raise ValueError(f"unknown serve mode {mode!r}")
    ok, why = shd.explicit_decode_supported(cfg, axis.n)
    if not ok:
        raise ValueError(f"mode='explicit' unsupported here: {why}")
    if comm is None:
        comm = comm_lib.Communicator(axis.name, n=axis.n, device=axis.device)
    if plans is None:
        plans = compile_decode_plans(cfg, comm, batch_local=batch, tp=axis.n,
                                     seq_buckets=seq_buckets)
    comms = TPDecodeComms(cfg, axis, hidden_plan=plans["layer_allreduce"],
                          logits_plan=plans.get("logits_allgather"),
                          moe_plan=plans.get("moe_alltoall"))
    return comms, StepLayout(
        params=lambda p: shd.explicit_decode_params(p, cfg, axis),
        cache=lambda: tf.init_cache(cfg, batch, max_kv, device=axis.device,
                                    dtype=dtype, ranks=axis.n))


def make_serve_step(cfg: ModelConfig, axis: RankAxis, *, batch: int,
                    max_kv: int, mode: str = "auto", comm=None, plans=None,
                    kv_quant: bool = False):
    """One-token decode step ``step(params, cache, tokens, pos) ->
    (logits, cache)`` and its :class:`StepLayout`.

    * ``auto`` — the unsharded model on ``axis.device``;
    * ``explicit`` — rank-stacked shards over ``axis`` (``axis.n`` TP
      ranks on one device); every per-layer AllReduce and the logits
      AllGather (and, for MoE, each layer's dispatch and combine
      all_to_all) replay the plans of ``plans`` (compiled here on ``comm``
      — by default a new :class:`~repro_torch.core.comm.Communicator`
      with the device's backend — when omitted).

    ``kv_quant``: the layout's cache is the int8 KV cache with its
    per-token scales; on the explicit path cache and scales are
    replicated over the ranks, so the int8 cache adds no collective. A
    hybrid model's explicit cache holds its SSM state rank-sharded.
    """
    comms, layout = _step_comms(cfg, axis, batch=batch, max_kv=max_kv,
                                mode=mode, comm=comm, plans=plans,
                                kv_quant=kv_quant)

    def step(params, cache, tokens, pos):
        return tf.decode_step(params, cfg, cache, tokens, pos, comms=comms)

    return step, layout


def make_sched_step(cfg: ModelConfig, axis: RankAxis, *, batch: int,
                    max_kv: int, kv_quant: bool = False, mode: str = "auto",
                    comm=None, plans=None):
    """The continuous-batching decode step ``step(params, cache, tokens,
    pos, active) -> (logits, cache)`` and its :class:`StepLayout` — the
    scheduler's hot path. It differs from :func:`make_serve_step` in the
    two ways continuous batching needs: ``pos`` is a ``(batch,)`` device
    tensor (each slot at its own depth: per-row RoPE, cache write and
    validity mask) and ``active`` a ``(batch,)`` bool tensor (an
    inactive slot's cache row and SSM state pass through bit for bit,
    written back in place rather than selected over the whole cache).
    Every op is row-independent, so a row's logits do not depend on its
    co-residents at one bucket. Pass the engine's ``comm``/``plans`` so
    every bucket's step replays the same plan objects."""
    b_local, _ = local_batch(axis, batch)
    comms, layout = _step_comms(cfg, axis, batch=b_local, max_kv=max_kv,
                                mode=mode, comm=comm, plans=plans,
                                kv_quant=kv_quant)

    def step(params, cache, tokens, pos, active):
        return tf.decode_step(params, cfg, cache, tokens, pos, comms=comms,
                              active=active)

    return step, layout


def make_prefill_sched_step(cfg: ModelConfig, axis: RankAxis, *, batch: int,
                            seq: int, max_kv: int, kv_quant: bool = False,
                            mode: str = "auto", comm=None, plans=None):
    """The scheduler's fused prefill micro-step ``step(params, cache,
    tokens, pos, n_tok) -> cache`` over ``(batch, seq)`` chunks, and its
    :class:`StepLayout` (``transformer.prefill_step``): each row's next
    ``n_tok`` prompt tokens from position ``pos`` go into its cache in
    one step, a row with ``n_tok == 0`` passes through bit for bit, and
    no logits come back. ``seq`` may not exceed the smallest layer
    ``kv_len`` (a wider chunk would overwrite ring slots its own queries
    read). Explicit mode replays the same plan families as the decode
    step, the AllReduce at the ``batch * seq`` row bucket that
    ``compile_decode_plans(seq_buckets=)`` adds (compiled with
    ``seq_buckets=(seq,)`` when ``plans`` is omitted)."""
    if cfg.family not in tf.DECODE_FAMILIES:
        raise ValueError(
            f"fused prefill covers the dense, MoE and hybrid families; "
            f"{cfg.family!r} prefills token by token through the decode "
            f"path")
    kv_lens = [min(w, max_kv) if w is not None else max_kv
               for w in tf.layer_windows(cfg)]
    if seq > min(kv_lens):
        raise ValueError(
            f"fused-prefill chunk length {seq} exceeds the smallest layer "
            f"kv_len {min(kv_lens)}: a chunk wider than the KV ring can "
            f"overwrite slots its own earlier queries still read")
    b_local, _ = local_batch(axis, batch)
    comms, layout = _step_comms(cfg, axis, batch=b_local, max_kv=max_kv,
                                mode=mode, comm=comm, plans=plans,
                                kv_quant=kv_quant, seq_buckets=(seq,))

    def step(params, cache, tokens, pos, n_tok):
        return tf.prefill_step(params, cfg, cache, tokens, pos, n_tok,
                               comms=comms)

    return step, layout


def cache_rows(cache: dict, b: int) -> dict:
    """Views of the first ``b`` batch rows of every cache leaf (axis −4
    of the KV leaves and their scales, −3 of the SSM state), for a step
    at slot bucket ``b``; the step writes them in place."""
    return {name: [leaf.narrow(leaf.dim() - (3 if name == "ssm" else 4),
                               0, b) for leaf in leaves]
            for name, leaves in cache.items()}


#: warm-up steps run before the capture (binds, tables, library handles)
WARMUP_STEPS = 2


class CapturedStep:
    """The one-token step captured once in a CUDA graph
    (:func:`capture_serve_step`); ``run(tokens, pos)`` replays it."""

    def __init__(self, graph, tokens, pos, logits, launches: int):
        self.graph = graph
        self.tokens = tokens              # static (b,) token buffer
        self.pos = pos                    # static 0-d position buffer
        self.logits = logits              # static (b, vocab) output
        #: executor launches made into the capture: every replay runs
        #: exactly these (the graph's executor nodes, each cooperative)
        self.launches = launches
        self.replays = 0

    def run(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Copy ``tokens`` in, set the position on the card, replay, and
        return a copy of the logits (the static output is overwritten by
        the next replay)."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        self.replays += 1
        return self.logits.clone()


class CapturedSchedStep:
    """The scheduler's step at one slot bucket, captured once in a CUDA
    graph (:func:`capture_sched_step`); ``run(inputs)`` replays it."""

    def __init__(self, graph, inputs, logits, launches: int):
        self.graph = graph
        #: static (3, b) int64 buffer: tokens, positions, active (0/1)
        self.inputs = inputs
        self.logits = logits              # static (b, vocab) output
        self.launches = launches          # executor launches captured
        self.replays = 0

    def run(self, inputs: torch.Tensor) -> torch.Tensor:
        """Copy the ``(3, b)`` inputs in and replay. Returns the static
        logits, valid until the next replay of any graph of the pool."""
        self.inputs.copy_(inputs)
        self.graph.replay()
        self.replays += 1
        return self.logits


class CaptureError(RuntimeError):
    """A captured graph is not the step it should hold (its executor
    kernel nodes are not the launches made into it, each cooperative, or
    it holds a traced node). Never transient: the serving guardrails
    re-raise it rather than retry it or fall back from the kernel."""


def _capture(run, device, *, reset=None, pool=None, check=None):
    """Capture ``run()`` once in a CUDA graph: it first runs
    :data:`WARMUP_STEPS` times on a side stream (binding every plan's
    :class:`~repro_torch.core.executor.CudaExecutor`, uploading the RoPE
    tables, creating the library handles, none of which a capture may
    do), then ``reset()``, then the capture on the same stream, into the
    memory ``pool`` when given. A step that reads a tensor on the host,
    or draws a host epoch, fails the capture: this raises, with no eager
    fallback. So does a graph whose executor kernel nodes are not the
    launches made into it, each with the cooperative attribute (its
    blocks spin on each other), or that holds a node of the traced
    kernel (:class:`CaptureError`). Returns (graph, run's output,
    launches captured).

    The capture is the port's trace time: the warm-ups run with the
    chaos hook suspended (``faults.suspended``), so a runtime fault
    fires into the graph. The capture runs in ``thread_local`` mode, and
    nothing here synchronizes the whole device, so a watchdog's worker
    thread may capture while another thread keeps working (and
    captures). ``check()``, when given, runs before every warm-up step,
    before ``reset``, before the capture and before the instantiation
    (a watchdog's abandoned worker raises there and touches nothing
    more). A capture that raises leaves nothing behind: ``reset`` has
    run after any warm-up step that ran, the stream is no longer
    capturing, the half-made graph is dropped and the executors' marks
    of shapes launched into it are taken back (its own, kept in this
    thread's :func:`~repro_torch.core.executor.capture_scope`, which
    also counts the launches made into it)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"steps are captured in CUDA graphs on a CUDA "
                         f"device; got {device} (run the step eagerly "
                         f"there)")
    from repro_torch.core import faults
    from repro_torch.core.executor import capture_scope, graph_nodes
    check = check or (lambda: None)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.inference_mode(), torch.cuda.stream(stream):
        try:
            with faults.suspended():
                for _ in range(WARMUP_STEPS):
                    check()
                    run()
            check()
        finally:
            if reset is not None:
                reset()
    torch.cuda.current_stream(device).wait_stream(stream)
    stream.synchronize()
    check()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with capture_scope() as scope:
        try:
            # what ``torch.cuda.graph`` does, less its device-wide
            # synchronize and cache flush on entry: neither is allowed in
            # one thread while another thread captures
            with torch.inference_mode(), torch.cuda.stream(stream):
                graph.capture_begin(*(() if pool is None else (pool,)),
                                    capture_error_mode="thread_local")
                try:
                    out = run()
                finally:
                    graph.capture_end()
            captured = scope.launches
            if captured:
                nodes, cooperative, traced = graph_nodes(graph)
                if not nodes == cooperative == captured or traced:
                    raise CaptureError(
                        f"the captured step holds {nodes} executor kernel "
                        f"nodes, {cooperative} of them cooperative, and "
                        f"{traced} traced nodes, for {captured} launches "
                        f"made into the capture")
            check()
        except BaseException:
            scope.discard()
            del graph
            raise
    graph.instantiate()
    return graph, out, captured


def capture_serve_step(step, params, cache, *, batch: int,
                       device: DeviceLike, keep_cache: bool = False,
                       check=None) -> CapturedStep:
    """Capture ``step(params, cache, tokens, pos)`` (from
    :func:`make_serve_step`) once in a CUDA graph over static ``tokens``
    ``(batch,)`` and 0-d ``pos`` buffers (:func:`_capture`). The cache
    (and its int8 scales) is zeroed after the warm-up steps, or, with
    ``keep_cache`` (a capture mid-stream, after a fallback), put back as
    it was before them. The graph reads ``params`` and writes ``cache``
    in place, so both must stay where they are while it lives.
    ``check`` goes to :func:`_capture`."""
    device = torch.device(device)
    tokens = torch.zeros(batch, dtype=torch.long, device=device)
    pos = torch.zeros((), dtype=torch.long, device=device)
    saved = ({k: [leaf.clone() for leaf in v] for k, v in cache.items()}
             if keep_cache else None)

    def reset():
        for name, leaves in cache.items():
            for j, leaf in enumerate(leaves):
                if saved is None:
                    leaf.zero_()
                else:
                    leaf.copy_(saved[name][j])

    graph, (logits, _), captured = _capture(
        lambda: step(params, cache, tokens, pos), device, reset=reset,
        check=check)
    return CapturedStep(graph, tokens, pos, logits, captured)


def capture_sched_step(step, params, cache, *, batch: int,
                       device: DeviceLike, pool=None) -> CapturedSchedStep:
    """Capture the scheduler's ``step(params, cache, tokens, pos,
    active)`` (from :func:`make_sched_step`) at slot bucket ``batch``
    once in a CUDA graph over a static ``(3, batch)`` input buffer
    (tokens, positions, active), into ``pool`` (one
    ``torch.cuda.graph_pool_handle()`` shared by every bucket's graph).
    ``cache`` is the bucket's view of the scheduler's cache
    (:func:`cache_rows`), written in place by every replay, so its
    leaves must never be replaced while the graph lives. The warm-up
    steps run with every row inactive, so they leave a live cache as it
    was."""
    device = torch.device(device)
    inputs = torch.zeros((3, batch), dtype=torch.long, device=device)
    graph, (logits, _), captured = _capture(
        lambda: step(params, cache, inputs[0], inputs[1], inputs[2] != 0),
        device, pool=pool)
    return CapturedSchedStep(graph, inputs, logits, captured)


def make_prefill_step(cfg: ModelConfig, *, device: DeviceLike = None):
    """Full-sequence forward returning last-position logits, ``step(
    params, tokens) -> (b, vocab)`` f32: the port of the reference's
    ``make_prefill_step`` in auto mode (cache filling is engine-side).
    ``tokens`` are ``(b, s)`` ints, or ``(b, s, d)`` float frames for a
    frontend arch; ``params`` lie on ``device`` (default: the CUDA card,
    raising where there is none)."""
    device = resolve_device(device)

    def step(params, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        with torch.inference_mode():
            hidden = tf.forward(params, cfg, tokens)
            return tf.logits_fn(params, cfg, hidden[:, -1:])[:, 0]

    return step
