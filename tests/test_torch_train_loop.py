"""The port's trainer (``repro_torch.distributed.step.make_train_step``,
``repro_torch.train.loop.run``) against the reference's, on reduced
llama3.2-3b at the reference tests' sizes (global batch 8, seq 32): the
reference's own ``init_params`` weights carried across with
``params_from_jax``, the same synthetic stream.

* explicit DP 2 (one flat AllReduce plan a leaf) and 2 x 2 (the
  hierarchical 2PH plans, the node axis costed on the reference's DCN
  link as the reference's is) against the reference's explicit
  ``train_loop.run`` on the same DP axes, losses within the reference
  test's ``rtol 2e-3, atol 1e-4``, with the plan count of every
  communicator equal to the reference's ``plan_stats`` and every plan's
  algorithm equal to the reference's;
* the bf16 wire (``dp_wire_dtype``) on the f32 model against the
  reference's step, the same bar;
* inside the port: explicit equal to auto to the same bar, every rank's
  reduced leaf equal to rank 0's (bit for bit, but for 1PA plans at more
  than two ranks: within the fold bound), checkpoint restart exact,
  elastic re-ranking from 2 x 4 to DP 4, and the launcher's lines.

Each reference trainer runs once, in a module-scoped fixture."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.core import selector as ref_sel
from repro.distributed import sharding as ref_shd
from repro.distributed import step as ref_step
from repro.models import transformer as ref_tf
from repro.train import data as ref_data
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch import configs, tree
from repro_torch.core import selector as sel
from repro_torch.distributed import step as st
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.mesh import RankAxis
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
BATCH, SEQ = 8, 32
# tests/test_train_integration.py's bar, explicit against auto
RTOL, ATOL = 2e-3, 1e-4
STEPS = 6


def _mesh(shape, names):
    devs = np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _cfg():
    return configs.reduced(configs.get_config(ARCH))


def _axes(*sizes):
    """DP axes of the given sizes, outermost first (pod, data)."""
    names = ("pod", "data")[-len(sizes):] if sizes else ()
    return tuple(RankAxis(n, s, "cpu") for n, s in zip(names, sizes))


@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    return jax.tree.map(np.asarray, ref_tf.init_params(cfg, jax.random.key(0)))


def _carried():
    return params_from_jax(_ref_params(), _cfg(), device="cpu")


def _tc(**kw):
    return loop.TrainConfig(**dict(dict(steps=STEPS, global_batch=BATCH,
                                        seq_len=SEQ, log_every=100), **kw))


def _algos(comms) -> dict:
    """Per communicator: every plan's (collective, payload shape, dtype,
    algorithm)."""
    return {name: sorted((p.collective, tuple(k[1]), str(k[2]), p.algo)
                         for k, p in c.plans().items())
            for name, c in comms.items()}


def _capturing(module, made, **kw):
    """``module.make_dp_communicators`` that keeps what it makes in
    ``made`` (and passes ``kw`` on)."""
    make = module.make_dp_communicators

    def capture(*args, **given):
        made.update(make(*args, **given, **kw))
        return made
    return capture


@pytest.fixture(scope="module")
def reference():
    """The reference's explicit runs: DP 2 on a (data 2, model 4) mesh,
    2 x 2 on (pod 2, data 2, model 2), and the bf16-wire step on DP 2;
    the 2 x 2 run's communicators are kept."""
    cfg = ref_configs.reduced(ref_configs.get_config(ARCH))
    out = {}
    out["flat"] = ref_loop.run(cfg, _mesh((2, 4), ("data", "model")),
                               ref_loop.TrainConfig(
                                   steps=STEPS, global_batch=BATCH,
                                   seq_len=SEQ, mode="explicit",
                                   log_every=100))
    comms = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_loop, "make_dp_communicators",
                   _capturing(ref_loop, comms))
        out["hier"] = ref_loop.run(
            cfg, _mesh((2, 2, 2), ("pod", "data", "model")),
            ref_loop.TrainConfig(steps=4, global_batch=BATCH, seq_len=SEQ,
                                 mode="explicit", log_every=100),
            ax=ref_shd.MeshAxes(data=("pod", "data")))
    out["hier"]["algos"] = _algos(comms)
    assert comms["node"].link == ref_sel.DCN
    mesh = _mesh((2, 4), ("data", "model"))
    oc = ref_opt.AdamWConfig(total_steps=3, warmup_steps=1)
    step, _ = ref_step.make_train_step(
        cfg, mesh, ref_shd.MeshAxes(), oc, mode="explicit",
        global_batch=BATCH, seq_len=SEQ, dp_wire_dtype=jnp.bfloat16)
    params, state = ref_step.init_sharded(cfg, mesh, ref_shd.MeshAxes(),
                                          jax.random.key(0),
                                          optimizer_cfg=oc)
    pipe = ref_data.SyntheticLM(ref_data.DataConfig(vocab=cfg.vocab,
                                                    batch=BATCH, seq_len=SEQ))
    losses = []
    for i in range(3):
        params, state, m = step(params, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    out["wire"] = losses
    return out


@pytest.fixture(scope="module")
def port():
    """The port's runs from the carried weights: auto, explicit DP 2 and
    explicit 2 x 2, the last with its node axis on the reference's DCN
    link (``make_dp_communicators(node_link=)``) and its communicators
    kept."""
    out = {"auto": loop.run(_cfg(), (), _tc(), params=_carried(),
                            device="cpu", log_fn=lambda s: None)}
    out["flat"] = loop.run(_cfg(), _axes(2), _tc(mode="explicit"),
                           params=_carried(), log_fn=lambda s: None)
    comms = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(st, "make_dp_communicators",
                   _capturing(st, comms, node_link=sel.DCN))
        out["hier"] = loop.run(_cfg(), _axes(2, 2),
                               _tc(mode="explicit", steps=4),
                               params=_carried(), log_fn=lambda s: None)
    out["hier"]["algos"] = _algos(comms)
    assert comms["node"].link == sel.DCN
    return out


@pytest.mark.parametrize("name", ["flat", "hier"])
def test_explicit_matches_reference(reference, port, name):
    got, want = port[name], reference[name]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    # one plan a distinct (shape, dtype) per phase, as the reference's
    assert {k: v["plans"] for k, v in got["plan_stats"].items()} == \
        {k: v["plans"] for k, v in want["plan_stats"].items()}
    if name == "hier":
        # each phase's plans picked the reference's algorithms
        assert got["algos"] == want["algos"]


@pytest.mark.parametrize("name", ["flat", "hier"])
def test_explicit_matches_auto(port, name):
    n = len(port[name]["losses"])
    np.testing.assert_allclose(port[name]["losses"],
                               port["auto"]["losses"][:n], rtol=RTOL,
                               atol=ATOL)


def test_bf16_wire_matches_reference(reference):
    cfg = _cfg()
    oc = opt.AdamWConfig(total_steps=3, warmup_steps=1)
    step = st.make_train_step(cfg, _axes(2), oc, mode="explicit",
                              global_batch=BATCH, seq_len=SEQ,
                              dp_wire_dtype=torch.bfloat16, device="cpu")
    params = _carried()
    state = opt.adamw_init(params)
    pipe = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                            seq_len=SEQ))
    losses, wire = [], []

    reduce_leaf = step.reduce_leaf

    def reduce(x, **kw):
        wire.append(x.dtype)
        return reduce_leaf(x, **kw)

    step.reduce_leaf = reduce
    for i in range(3):
        params, state, m = step(params, state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, reference["wire"], rtol=RTOL,
                               atol=ATOL)
    # the stacked leaves stay f32; the plans ran on the bf16 wire
    assert set(wire) == {torch.float32}
    assert {k[2] for k in step.comms["flat"].plans()} == {"bfloat16"}


@pytest.mark.parametrize("sizes,exact", [((2,), True), ((2, 2), True),
                                         ((2, 4), True), ((4,), False)],
                         ids=["flat2", "2x2", "2x4", "flat4"])
def test_every_rank_reduces_to_the_same_leaf(sizes, exact):
    """Every rank's reduced copy of every leaf, against rank 0's and
    against the global batch's gradient. Bit-equal where each rank's sum
    is folded in one order: two ranks (a + b = b + a), and the 2PA and
    2PH plans, whose ranks each reduce one chunk and gather the rest. A
    1PA plan at 4 ranks folds each rank's sum from its own buffer, so
    there the copies agree within the fold bound only (the reference's
    plans fold alike: ``test_dp4_rank_copies_fold_as_the_reference``);
    the step feeds rank 0's copy to the update."""
    cfg = _cfg()
    step = st.make_train_step(cfg, _axes(*sizes), opt.AdamWConfig(),
                              mode="explicit", global_batch=BATCH,
                              seq_len=SEQ, device="cpu")
    batch = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                             seq_len=SEQ)).batch_at(0)
    params = _carried()
    loss, stacked = step.rank_grads(params, batch)
    _, want = st.make_train_step(cfg, (), opt.AdamWConfig(),
                                 global_batch=BATCH, seq_len=SEQ,
                                 device="cpu").value_and_grad(
        params, step.batch(batch))
    ndp = stacked[0].shape[0]
    eps = torch.finfo(torch.float32).eps
    for x, w in zip(stacked, want):
        red = step.reduce_leaf(x)
        assert red.shape == x.shape and red.dtype == x.dtype
        bound = (ndp - 1) * eps * x.abs().sum(0) / ndp
        for r in range(1, ndp):
            if exact:
                assert torch.equal(red[r], red[0])
            else:
                assert torch.all((red[r] - red[0]).abs() <= bound)
        # the mean of the ranks' gradients is the global batch's
        np.testing.assert_allclose(red[0].numpy(), w.numpy(), rtol=RTOL,
                                   atol=1e-6)
    assert torch.isfinite(loss)


def test_checkpoint_restart_exact(tmp_path):
    """Stop at step 5, restart, and the final params equal the
    uninterrupted run's bit for bit (the CPU is deterministic)."""
    cfg = _cfg()
    tc = dict(global_batch=BATCH, seq_len=SEQ, log_every=100, ckpt_every=5,
              mode="explicit")
    oc = opt.AdamWConfig(total_steps=10, warmup_steps=2)
    full = loop.run(cfg, _axes(2), loop.TrainConfig(steps=10, **tc), oc,
                    params=_carried(), log_fn=lambda s: None)
    d = tmp_path / "ck"
    loop.run(cfg, _axes(2), loop.TrainConfig(steps=5, ckpt_dir=str(d), **tc),
             oc, params=_carried(), log_fn=lambda s: None)
    ckpt.wait_pending()
    logs = []
    resumed = loop.run(cfg, _axes(2),
                       loop.TrainConfig(steps=10, ckpt_dir=str(d), **tc), oc,
                       params=_carried(), log_fn=logs.append)
    assert "[ckpt] resumed from step 5" in logs
    assert resumed["losses"] == full["losses"][5:]
    for a, b in zip(tree.leaves([full["params"], full["opt_state"]]),
                    tree.leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)


def test_elastic_reranking(tmp_path):
    """Train on a 2 x 4 grid, lose half the ranks, resume on DP 4: the
    checkpoint holds one copy of the state, and the resumed losses are
    the uninterrupted 2 x 4 run's within the explicit bar."""
    cfg = _cfg()
    d = str(tmp_path / "ck")
    tc = dict(global_batch=BATCH, seq_len=SEQ, log_every=100, mode="explicit")
    oc = opt.AdamWConfig(total_steps=8, warmup_steps=1)
    loop.run(cfg, _axes(2, 4), loop.TrainConfig(steps=4, ckpt_dir=d,
                                                 ckpt_every=2, **tc), oc,
             params=_carried(), log_fn=lambda s: None)
    ckpt.wait_pending()
    assert ckpt.latest_steps(d) == [2, 4]
    r = loop.run(cfg, _axes(4), loop.TrainConfig(steps=8, ckpt_dir=d, **tc),
                 oc, params=_carried(), log_fn=lambda s: None)
    full = loop.run(cfg, _axes(2, 4), loop.TrainConfig(steps=8, **tc), oc,
                    params=_carried(), log_fn=lambda s: None)
    assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
    np.testing.assert_allclose(r["losses"], full["losses"][4:], rtol=RTOL,
                               atol=ATOL)
    assert set(r["plan_stats"]) == {"flat"}
    assert set(full["plan_stats"]) == {"node", "local"}


def test_launcher_prints_its_lines(capsys):
    assert launch_train.main(["--arch", "qwen3-1.7b", "--reduced",
                              "--steps", "3", "--batch", "4", "--seq", "16",
                              "--mode", "explicit", "--dp", "4", "--nodes",
                              "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b-reduced" in out
    assert "mesh=(2,2) mode=explicit" in out
    assert "step 0: loss=" in out and "final loss " in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--dp", "3",
                           "--nodes", "2", "--device", "cpu"])


def test_dp4_rank_copies_fold_as_the_reference():
    """The fold-bound exception above rests on the reference: at DP 4 every
    rank's reduced copy of every leaf, from the port's flat plan, is bit
    for bit the reference's ``Communicator.all_reduce`` on the same
    rank-stacked gradient (inside ``shard_map``, every rank's output kept)
    on the port's link constants, the same algorithms; and the reference's
    own rank copies differ for some leaves (its 1PA plans), so the
    exception is the reference's fold, not the port's."""
    from repro.compat import shard_map
    from repro.core import comm as ref_comm
    from jax.sharding import PartitionSpec as P
    cfg = _cfg()
    step = st.make_train_step(cfg, _axes(4), opt.AdamWConfig(),
                              mode="explicit", global_batch=BATCH,
                              seq_len=SEQ, device="cpu")
    batch = data.SyntheticLM(data.DataConfig(vocab=cfg.vocab, batch=BATCH,
                                             seq_len=SEQ)).batch_at(0)
    _, stacked = step.rank_grads(_carried(), batch)
    mesh = _mesh((4,), ("data",))
    rc = ref_comm.Communicator("data", n=4, link=ref_sel.LinkModel(
        **dataclasses.asdict(sel.UNFITTED)))
    differ = 0
    for leaf in stacked:
        x = step.payload(leaf)
        plan = step.plan_for(x)
        got = plan(x)
        n, rows, cols = x.shape
        want = np.asarray(jax.jit(shard_map(
            lambda b: rc.all_reduce(b, backend="xla"), mesh=mesh,
            in_specs=P("data", None), out_specs=P("data", None),
            check_vma=False))(x.numpy().reshape(n * rows, cols)))
        want = want.reshape(n, rows, cols)
        np.testing.assert_array_equal(got.numpy(), want)
        differ += any(not np.array_equal(want[r], want[0])
                      for r in range(1, n))
    assert {p.algo for p in step.comms["flat"].plans().values()} == \
        {p.algo for p in rc.plans().values()}
    assert differ > 0


class _NoHostRead(TorchDispatchMode):
    """Fails on every op that reads a tensor on the host: ``.item()``,
    ``int()`` and ``bool()`` of a tensor (``_local_scalar_dense``) and
    ``nonzero`` (its output size)."""

    FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket).startswith(self.FORBIDDEN):
            raise AssertionError(f"host read inside the step: {func}")
        return func(*args, **(kwargs or {}))


def test_rank_pass_and_update_read_nothing_on_the_host():
    """One rank's forward+backward and the AdamW update dispatch no op that
    reads a tensor on the host (after a first pass, which builds the RoPE
    tables): on the card such a read, like a host tensor's copy, waits for
    the stream, and the step's device time would be the host's."""
    cfg = _cfg()
    step = st.make_train_step(cfg, (), opt.AdamWConfig(), global_batch=BATCH,
                              seq_len=SEQ, device="cpu")
    params = _carried()
    state = opt.adamw_init(params)
    batch = step.batch(data.SyntheticLM(data.DataConfig(
        vocab=cfg.vocab, batch=BATCH, seq_len=SEQ)).batch_at(0))
    step.value_and_grad(params, batch)
    with _NoHostRead():
        loss, grads = step.value_and_grad(params, batch)
        params, state, m = opt.adamw_update(
            opt.AdamWConfig(), params, tree.unflatten(params, grads), state,
            donate=True)
    assert torch.isfinite(loss) and torch.isfinite(m["grad_norm"])
