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
  launch on the card;
* :func:`make_train_step` builds the data-parallel train step (the
  trainer half): ``auto`` (one model over the global batch) or
  ``explicit`` (the DP ranks' gradients stacked on the card and every
  leaf reduced by compiled plans that the executor kernel replays: the
  hierarchical 2PH plan over two DP axes, :func:`make_dp_communicators`,
  or one flat AllReduce plan), then AdamW; :func:`init_sharded` makes
  the params and the optimizer state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import selector as sel
from repro_torch.core import spans
from repro_torch.distributed import fsdp as fsdp_lib
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.moe_parallel import ep_capacity, moe_layer_ep
from repro_torch.mesh import DeviceLike, RankAxis, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt

__all__ = ["local_batch", "slot_buckets", "seq_bucket_rows",
           "compile_decode_plans", "TPDecodeComms", "make_serve_step",
           "make_sched_step", "make_prefill_sched_step", "batch_axis",
           "cache_rows",
           "capture_serve_step", "capture_sched_step", "CapturedStep",
           "CapturedSchedStep", "CaptureError", "make_prefill_step",
           "StepLayout", "init_sharded", "make_dp_communicators",
           "make_train_step", "TrainStep"]


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
    none (fused prefill makes no logits).

    Every decoding family gets its plans, as in the reference: the rwkv6
    family's ``layer_allreduce`` and ``logits_allgather`` are compiled
    (and exported with a replica's plan set) though nothing replays them,
    since its explicit step stays refused
    (:func:`~repro_torch.distributed.sharding.explicit_decode_supported`)."""
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
        spans.mark("step.begin")
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
    if cfg.family not in tf.PREFILL_FAMILIES:
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
        spans.mark("step.begin")
        return tf.prefill_step(params, cfg, cache, tokens, pos, n_tok,
                               comms=comms)

    return step, layout


#: where a cache leaf holds its batch rows, counted from its last axis
#: (a leading rank or groups axis or not): the SSM state ``(…, b,
#: d_inner, state)`` and the rwkv6 token shifts ``(…, b, d)``; every
#: other leaf (K/V, their int8 scales, rwkv6's ``wkv (…, b, nh, 64,
#: 64)``) at −4
_BATCH_FROM_END = {"ssm": 3, "shift_t": 2, "shift_c": 2}


def batch_axis(name: str, leaf: torch.Tensor) -> int:
    """The batch axis of the cache leaf ``leaf`` of kind ``name``."""
    return leaf.dim() - _BATCH_FROM_END.get(name, 4)


def cache_rows(cache: dict, b: int) -> dict:
    """Views of the first ``b`` batch rows of every cache leaf
    (:func:`batch_axis`), for a step at slot bucket ``b``; the step
    writes them in place."""
    return {name: [leaf.narrow(batch_axis(name, leaf), 0, b)
                   for leaf in leaves]
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


def make_prefill_step(cfg: ModelConfig, *, device: DeviceLike = None,
                      dp_axes=(), fsdp: bool = False,
                      dp_comms: Optional[dict] = None, fsdp_ranks=None,
                      backend: Optional[str] = None):
    """Full-sequence forward returning last-position logits, ``step(
    params, tokens) -> (b, vocab)`` f32: the port of the reference's
    ``make_prefill_step`` in auto mode (cache filling is engine-side).
    ``tokens`` are ``(b, s)`` ints, or ``(b, s, d)`` float frames for a
    frontend arch; ``params`` lie on ``device`` (default: the CUDA card,
    raising where there is none).

    ``fsdp=True`` with DP axes ``dp_axes`` (``RankAxis`` es, outermost
    first; the reference's ``fsdp=True`` over its data axes): the batch
    splits over the DP ranks, each holding its shards
    (``distributed/fsdp.py``; ``step.fsdp.layout.shard(params)`` makes the
    held tree the step then takes), each group gathered by plans just
    before it runs (``dp_comms``: built on the device's backend when
    omitted),
    and the logits come back in rank order. Without DP axes ``fsdp``
    changes nothing. ``fsdp_ranks`` (the dry run): the DP ranks this
    device runs. ``backend`` names the attention core (``blocks.
    attention``)."""
    device = resolve_device(device)
    if fsdp and dp_axes:
        dp_axes = tuple(dp_axes)
        ndp = 1
        for a in dp_axes:
            ndp *= a.n
        comms = dp_comms if dp_comms is not None else \
            make_dp_communicators(dp_axes)
        fs = fsdp_lib.FsdpPass(
            cfg, fsdp_lib.FsdpLayout(
                cfg, fsdp_lib.dp_grid(dp_axes),
                local=None if fsdp_ranks is None else len(fsdp_ranks)),
            fsdp_lib.FsdpComms(comms), ndp=ndp, ranks=fsdp_ranks,
            backend=backend)

        def sharded_step(held, tokens):
            tokens = torch.as_tensor(tokens, device=device)
            with torch.inference_mode():
                return fs.prefill_logits(held, tokens)

        sharded_step.fsdp = fs
        return sharded_step

    def step(params, tokens):
        tokens = torch.as_tensor(tokens, device=device)
        with torch.inference_mode():
            hidden = tf.forward(params, cfg, tokens, backend=backend)
            return tf.logits_fn(params, cfg, hidden[:, -1:])[:, 0]

    return step


# ---------------------------------------------------------------------------
# the trainer: data-parallel steps, gradients reduced through DP plans
# ---------------------------------------------------------------------------
def init_sharded(cfg: ModelConfig, *, device: DeviceLike = None,
                 seed: int = 0, optimizer_cfg=None):
    """Seeded params and, with ``optimizer_cfg``, their AdamW state, on
    ``device`` (default: the CUDA card). The port has no GSPMD: both are
    whole on the device, and every DP rank of the explicit step reads the
    one copy."""
    params = tf.init_params(cfg, device=device, seed=seed)
    if optimizer_cfg is None:
        return params, None
    return params, opt.adamw_init(params)


def make_dp_communicators(dp_axes, *, backend: Optional[str] = None,
                          node_link: sel.LinkModel = sel.UNFITTED) -> dict:
    """Init-once communicators for the DP gradient-reduction axes (paper
    §5.2's deployment shape: plan at setup, replay every step).
    ``dp_axes`` are :class:`~repro_torch.mesh.RankAxis` es, outermost
    first.

    Two DP axes give ``{"node", "local"}``: a node-major
    :class:`~repro_torch.mesh.RankGrid` of ``dp_axes[0].n`` nodes of
    ``dp_axes[1].n`` ranks, reduced by the hierarchical 2PH plans. One
    gives ``{"flat"}``, none ``{}``. Links default to
    ``selector.UNFITTED``. ``node_link`` costs the node axis on another
    link: the reference's is ``selector.DCN``, a TPU constant, which the
    CPU tests pass to hold every phase's plan to the reference's
    algorithm."""
    dp_axes = tuple(dp_axes)
    if len(dp_axes) > 2:
        raise ValueError(f"at most two DP axes (node, local), got "
                         f"{[a.name for a in dp_axes]}")
    mk = lambda a, **kw: comm_lib.Communicator(  # noqa: E731
        a.name, n=a.n, device=a.device, backend=backend, **kw)
    if len(dp_axes) == 2:
        return {"node": mk(dp_axes[0], link=node_link),
                "local": mk(dp_axes[1])}
    if len(dp_axes) == 1:
        return {"flat": mk(dp_axes[0])}
    return {}


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    built by :func:`make_train_step`; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d f32 tensors on the device.

    ``auto``: one unsharded model's loss and gradients over the global
    batch. ``explicit``: the global batch splits over the ``ndp`` DP ranks
    (rank = node * L + local, rows ``[r * b/ndp, (r + 1) * b/ndp)``, the
    reference's batch sharding); each rank's gradients are computed in
    turn and written into a rank-stacked buffer one leaf at a time
    (:meth:`rank_grads`), then every leaf is reduced through the DP plans
    (:meth:`reduce_leaf`) and one rank's copy feeds the update. The loss
    is the mean of the ranks' losses (the reference's ``pmean``)."""

    def __init__(self, cfg: ModelConfig, opt_cfg, *, mode: str,
                 ndp: int, comms: dict, global_batch: int, seq_len: int,
                 remat_policy: str, dp_wire_dtype, device: torch.device):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.mode = mode
        self.ndp = ndp
        self.comms = comms
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.remat_policy = remat_policy
        self.dp_wire_dtype = dp_wire_dtype
        self.device = device
        #: the FSDP ranks' passes (``distributed/fsdp.py``), or None
        self.fsdp = None

    def shard(self, params: dict) -> dict:
        """The tree the step takes: under FSDP each leaf's held shards
        (:meth:`FsdpLayout.shard`), else ``params`` as they are."""
        return params if self.fsdp is None else self.fsdp.layout.shard(
            params)

    def __call__(self, params, opt_state, batch):
        """One step. The params and the optimizer state are updated in
        place (the reference step donates them), so a step holds one
        copy."""
        loss, grads = self.grads(params, batch)
        params, opt_state, metrics = opt.adamw_update(
            self.opt_cfg, params, grads, opt_state, donate=True)
        return params, opt_state, dict(metrics, loss=loss)

    # -- gradients ---------------------------------------------------------
    def value_and_grad(self, params, batch):
        """(loss, the gradient of every leaf in the reference's order)
        over ``batch`` on one unsharded model."""
        leaves = tree_lib.leaves(params)
        with torch.enable_grad():
            xs = [p.detach().requires_grad_() for p in leaves]
            loss = tf.loss_fn(tree_lib.unflatten(params, xs), self.cfg,
                              batch, remat_policy=self.remat_policy,
                              attn_backend="torch")
            # a leaf the loss never reads (a frontend arch's embedding)
            # gets zeros, as under jax.grad
            grads = list(torch.autograd.grad(loss, xs, allow_unused=True,
                                             materialize_grads=True))
        return loss.detach(), grads

    def batch(self, batch) -> dict:
        """``batch`` on the step's device, its shape checked."""
        lead = tuple(batch["tokens"].shape[:2])
        if lead != (self.global_batch, self.seq_len) or tuple(
                batch["labels"].shape) != lead:
            raise ValueError(
                f"the step was built for ({self.global_batch}, "
                f"{self.seq_len}) batches, got tokens "
                f"{tuple(batch['tokens'].shape)} and labels "
                f"{tuple(batch['labels'].shape)}")
        return {k: v.to(self.device) for k, v in batch.items()}

    def grads(self, params, batch):
        """(loss, grads as a tree of ``params``' structure): the auto
        step's, or the explicit step's reduced and averaged copy (rank
        0's, the one that feeds the update)."""
        batch = self.batch(batch)
        if self.fsdp is not None:
            return self.fsdp.grads(params, batch)
        if self.mode == "auto":
            loss, grads = self.value_and_grad(params, batch)
            return loss, tree_lib.unflatten(params, grads)
        loss, stacked = self.rank_grads(params, batch)
        grads = []
        for i in range(len(stacked)):
            grads.append(self.reduce_leaf(stacked[i], rank=0))
            stacked[i] = None               # one stacked leaf at a time
        return loss, tree_lib.unflatten(params, grads)

    def rank_grads(self, params, batch):
        """(mean loss over the ranks, one rank-stacked ``(ndp, *shape)``
        gradient a leaf): rank ``r``'s loss and gradients over its rows
        of the global batch, computed in turn."""
        batch = self.batch(batch)
        rows = self.global_batch // self.ndp
        leaves = tree_lib.leaves(params)
        stacked = [torch.empty((self.ndp,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device) for p in leaves]
        losses = []
        for r in range(self.ndp):
            sub = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            loss, g = self.value_and_grad(params, sub)
            for i in range(len(g)):
                stacked[i][r].copy_(g[i])
                g[i] = None
            losses.append(loss)
        return torch.stack(losses).mean(), stacked

    def payload(self, stacked: torch.Tensor) -> torch.Tensor:
        """A rank-stacked leaf ``(ndp, *shape)`` as the plans' payload:
        ``reshape(-1, last)`` (``(-1, 1)`` for a 1-d leaf) on every rank,
        cast to ``dp_wire_dtype`` when set."""
        ndp, shape = stacked.shape[0], tuple(stacked.shape[1:])
        x = stacked.reshape(ndp, -1, shape[-1]) if len(shape) >= 2 \
            else stacked.reshape(ndp, -1, 1)
        return x if self.dp_wire_dtype is None else x.to(self.dp_wire_dtype)

    def plan_for(self, x: torch.Tensor, comms: Optional[dict] = None):
        """The plan that reduces payload ``x`` (:meth:`payload`): the
        hierarchical 2PH plan (two DP axes), the flat AllReduce plan (one),
        or None (no DP axis). ``comms`` replaces the step's
        communicators."""
        comms = self.comms if comms is None else comms
        if "node" in comms:
            return comm_lib.hierarchical_plan(
                tuple(x.shape[1:]), x.dtype, local=comms["local"],
                node=comms["node"])
        if "flat" in comms:
            return comms["flat"].compile("all_reduce", tuple(x.shape[1:]),
                                         x.dtype)
        return None

    def reduce_leaf(self, stacked: torch.Tensor, *,
                    comms: Optional[dict] = None,
                    rank: Optional[int] = None) -> torch.Tensor:
        """The reference's ``reduce_leaf`` on every rank at once:
        ``(ndp, *shape)`` -> every rank's reduced copy over ``ndp``, in
        the leaf's shape and type; with ``rank``, that rank's copy alone
        (the one the step's update reads), the others never divided. The
        payload (:meth:`payload`) is replayed through :meth:`plan_for`'s
        plan, whose kernel scratch is released after its replay, so one
        leaf's scratch is held at a time. ``comms`` (e.g. the same axes on
        the plain executor) replaces the step's communicators; plans run
        on each communicator's backend."""
        ndp, shape = stacked.shape[0], tuple(stacked.shape[1:])
        x = self.payload(stacked)
        plan = self.plan_for(x, comms)
        if plan is None:
            red = x
        else:
            red = plan(x)
            plan.release()
        if rank is not None:
            return (red[rank] / ndp).reshape(shape).to(stacked.dtype)
        return (red / ndp).reshape(stacked.shape).to(stacked.dtype)

    def plan_stats(self) -> dict:
        """Per communicator: its compile/hit counters and plan count (the
        reference loop's ``plan_stats``)."""
        return {name: dict(c.stats, plans=len(c.plans()))
                for name, c in self.comms.items()}


def make_train_step(cfg: ModelConfig, dp_axes, opt_cfg, *,
                    mode: str = "auto", global_batch: int, seq_len: int,
                    remat_policy: str = "none",
                    dp_backend: Optional[str] = None, dp_wire_dtype=None,
                    fsdp: bool = False, dp_comms: Optional[dict] = None,
                    device: DeviceLike = None,
                    fsdp_ranks=None) -> TrainStep:
    """The train step over the DP axes ``dp_axes`` (``RankAxis`` es,
    outermost first; they name the device, else ``device``, default the
    CUDA card). ``mode`` is ``"auto"`` or ``"explicit"`` (see
    :class:`TrainStep`).

    ``dp_comms``: the explicit mode's communicators
    (:func:`make_dp_communicators`, built here on ``dp_backend`` when
    omitted); pass your own to install tuning tables or inspect plan
    caches. ``dp_backend=None`` is the device's backend: the executor
    kernel on the card, ``TorchExecutor`` on the CPU. ``dp_wire_dtype`` casts every leaf
    before its plan (the bf16 wire). The step updates the params and the
    optimizer state in place, as the reference's donates them.

    ``fsdp=True`` (``distributed/fsdp.py``): in explicit mode each DP
    rank holds only its shard of every leaf and of the AdamW state (the
    reference's ``apply_fsdp`` specs over the innermost DP axis), a
    group's weights are gathered by plans just before it runs, and the
    gradients reach the shards by reduce-scatter plans (all-reduce for a
    group one rank owns, and for a leaf held whole). The step then takes
    and updates held trees: :meth:`TrainStep.shard` makes one from
    reference-layout params, ``optimizer.adamw_init`` its state. Auto mode
    has no ranks, so there ``fsdp=True`` computes as the auto step
    without it, as the reference's auto step computes the same math.
    ``fsdp_ranks`` (the dry run): the DP ranks this device runs, each
    holding one shard, in place of all of them."""
    if mode not in ("auto", "explicit"):
        raise ValueError(f"mode must be 'auto' or 'explicit', got {mode!r}")
    dp_axes = tuple(dp_axes)
    devices = {a.device for a in dp_axes}
    if len(devices) > 1:
        raise ValueError(f"DP axes on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop() if devices else resolve_device(device)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"the DP axes lie on {dev}, not {device}")
    ndp = 1
    for a in dp_axes:
        ndp *= a.n
    if mode == "explicit" and global_batch % ndp:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {ndp} DP ranks")
    if dp_comms is not None and dp_backend is not None:
        raise ValueError("dp_backend builds the step's communicators; "
                         "given dp_comms run on their own backend")
    comms = {}
    if mode == "explicit":
        comms = dp_comms if dp_comms is not None else \
            make_dp_communicators(dp_axes, backend=dp_backend)
    step = TrainStep(cfg, opt_cfg, mode=mode, ndp=ndp if mode == "explicit"
                     else 1, comms=comms, global_batch=global_batch,
                     seq_len=seq_len, remat_policy=remat_policy,
                     dp_wire_dtype=dp_wire_dtype, device=dev)
    if fsdp and mode == "explicit" and dp_axes:
        step.fsdp = fsdp_lib.FsdpPass(
            cfg, fsdp_lib.FsdpLayout(
                cfg, fsdp_lib.dp_grid(dp_axes),
                local=None if fsdp_ranks is None else len(fsdp_ranks)),
            fsdp_lib.FsdpComms(comms), ndp=ndp, ranks=fsdp_ranks,
            dp_wire_dtype=dp_wire_dtype)
    return step
