"""The port's plan layer: compile-once counters, bucketed padding with
the ``rows`` and ``tiled`` strategies, JSON round trips, and a plan set
exported by the reference loading in the port and replaying bit-equal."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs as ref_configs
from repro.compat import shard_map
from repro.core import comm as ref_comm
from repro.distributed import step as ref_step
from repro_torch import configs
from repro_torch.core import comm
from repro_torch.core.comm import (BucketedPlan, Communicator, ExecutionPlan,
                                   default_backend, load_plan_set)
from repro_torch.core.dsl import program_to_dict
from repro_torch.kernels import ref
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.models import transformer as tf

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)


def _x(n, rows, cols, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, rows, cols).astype(np.float32))


def test_compile_once_counters():
    c = Communicator("model", n=4, device="cpu")
    p1 = c.compile("all_reduce", (8, 64), torch.float32)
    p2 = c.compile("all_reduce", (8, 64), "float32")
    assert p1 is p2
    assert c.stats == {"compiles": 1, "hits": 1}
    c.compile("all_reduce", (8, 64), torch.bfloat16)
    c.compile("all_gather", (8, 64), torch.float32)
    assert c.stats["compiles"] == 3
    assert c.health["verified"] == 3
    b1 = c.plan_for("all_reduce", (8, 64), torch.float32, buckets=(2, 4, 8))
    b2 = c.plan_for("all_reduce", (8, 64), torch.float32, buckets=(8, 4, 2))
    assert b1 is b2 and b1.plans[8] is p1        # buckets reuse plans


@pytest.mark.parametrize("rows", [1, 3, 5, 8])
def test_bucketed_rows_padding(rows):
    n, cols = 4, 16
    c = Communicator("model", n=n, device="cpu")
    bp = c.plan_for("all_reduce", (8, cols), torch.float32,
                    buckets=(2, 4, 8))
    assert bp.pad_strategy == "rows"
    x = _x(n, rows, cols, seed=rows)
    got = bp(x)
    assert got.shape == x.shape
    torch.testing.assert_close(got, ref.all_reduce_ref(x),
                               rtol=1e-6, atol=1e-6)   # sum order differs
    assert bp.hits[bp.bucket_for(rows)] == 1


@pytest.mark.parametrize("rows", [1, 3, 4])
def test_bucketed_tiled_padding(rows):
    """all_gather pads each rank's input tail; the padding is sliced out
    of every rank's block of the gathered output."""
    n, cols = 4, 6
    c = Communicator("model", n=n, device="cpu")
    bp = c.plan_for("all_gather", (4, cols), torch.float32, buckets=(2, 4))
    assert bp.pad_strategy == "tiled"
    x = _x(n, rows, cols, seed=rows)
    got = bp(x)
    want = ref.all_gather_ref(x).reshape(n, n * rows, cols)
    assert torch.equal(got, want)


def test_bucket_overflow_and_unported_strategy():
    c = Communicator("model", n=2, device="cpu")
    bp = c.plan_for("all_reduce", (4, 8), torch.float32, buckets=(2, 4))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        bp(_x(2, 5, 8))
    # the 'blocks' families: payload rows must split into per-rank blocks
    with pytest.raises(ValueError, match="per-rank blocks"):
        c.plan_for("all_to_all", (7, 8), torch.float32, buckets=(4,))


def test_json_round_trip():
    n = 4
    c = Communicator("model", n=n, device="cpu")
    plan = c.compile("all_reduce", (5, 32), torch.float32, opt_level=3)
    back = ExecutionPlan.from_json(plan.to_json(), device="cpu")
    assert program_to_dict(back.program) == program_to_dict(plan.program)
    assert (back.algo, back.pad, back.opt_level) == \
        (plan.algo, plan.pad, plan.opt_level)
    x = _x(n, 5, 32)
    assert torch.equal(back(x), plan(x))
    bp = c.plan_for("all_gather", (4, 8), torch.float32, buckets=(1, 2, 4))
    bp(_x(n, 2, 8))
    bback = BucketedPlan.from_json(bp.to_json(), device="cpu")
    assert bback.buckets == bp.buckets and bback.hits == bp.hits
    y = _x(n, 3, 8, seed=1)
    assert torch.equal(bback(y), bp(y))


def _ref_replay(plan, x):
    mesh = Mesh(np.asarray(jax.devices()[:plan.n]), (plan.axis,))
    spec = P(plan.axis, None, None)
    f = jax.jit(shard_map(lambda xs: plan(xs[0])[None], mesh=mesh,
                          in_specs=spec, out_specs=spec, check_vma=False))
    return np.asarray(f(x))


@pytest.mark.parametrize("tp", [2, 4])
def test_reference_plan_set_loads_and_replays_bit_equal(tmp_path, tp):
    """The reference's decode plan set (its backend 'xla' in the files)
    loads in the port, prepared with the port's CPU backend, replays
    every bucket bit-equal to the reference, and serves an Engine."""
    cfg_ref = ref_configs.reduced(ref_configs.get_config("qwen3-1.7b"))
    rcomm = ref_comm.Communicator("model", n=tp, backend="xla")
    ref_plans = ref_step.compile_decode_plans(cfg_ref, rcomm, batch_local=4,
                                              tp=tp)
    ref_comm.export_plan_set(ref_plans, tmp_path)
    plans = load_plan_set(tmp_path, device="cpu")
    assert set(plans) == set(ref_plans) == {"layer_allreduce",
                                            "logits_allgather"}
    for name, bp in plans.items():
        rbp = ref_plans[name]
        assert bp.buckets == rbp.buckets
        for b, plan in bp.plans.items():
            assert plan.backend == "torch" and plan.algo == rbp.plans[b].algo
            x = _x(tp, b, plan.shape[1], seed=b)
            np.testing.assert_array_equal(
                plan(x).numpy(), _ref_replay(rbp.plans[b], x.numpy()))
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    eng = Engine(cfg, tf.init_params(cfg, device="cpu"),
                 ServeConfig(batch=4, max_kv=16), tp=tp, device="cpu",
                 mode="explicit", decode_plans=plans)
    logits = eng.prefill(np.zeros((4, 2), np.int32))
    assert logits.shape == (4, cfg.vocab) and torch.isfinite(logits).all()
    assert eng.comm.stats["compiles"] == 0          # nothing recompiled


def test_plan_set_mismatch_raises(tmp_path):
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    c = Communicator("model", n=2, device="cpu")
    plans = {"layer_allreduce": c.plan_for("all_reduce", (4, 64),
                                           "float32", buckets=(4,))}
    # the engine rejects the set as the reference's does: a warning
    # naming the mismatch, then auto, counted as a fallback
    with pytest.warns(UserWarning, match="d_model"):
        eng = Engine(cfg, tf.init_params(cfg, device="cpu"),
                     ServeConfig(batch=4, max_kv=16), tp=2, device="cpu",
                     mode="explicit", decode_plans=plans)
    assert (eng.mode, eng.requested_mode) == ("auto", "explicit")
    assert eng.health["fallbacks"] == 1 and eng.decode_plans == {}


def test_backends_follow_the_device():
    assert default_backend("cpu") == "torch"
    c = Communicator("model", n=2, device="cpu")
    assert c.backend == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        c.compile("all_reduce", (2, 8), torch.float32, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        Communicator("model", n=2, device="cpu", backend="xla")
    assert comm.BACKENDS == ("torch", "cuda")
