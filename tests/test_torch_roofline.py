"""The port's roofline (``repro_torch.roofline``) and dry run against the
reference's.

* ``roofline()``'s arithmetic against ``repro.roofline.analysis.
  roofline`` on the same counts, with a test-built ``HW`` holding the
  reference's ``V5E`` figures (so no TPU figure enters the port);
* ``op_stats.analyze``'s matmul FLOPs of each reduced family's forward
  against ``repro.roofline.hlo_parse.analyze`` on the reference's
  compiled forward, within 1 %;
* the plan recorder's bytes and links on hand-counted plans;
* ``dryrun.run_cell`` on a reduced config and a 2 x 2 grid for one
  decode, one train and one prefill cell, and the CLI's ``--list``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.roofline import analysis as ref_roof
from repro.roofline import hlo_parse
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.mesh import NamedGrid
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import op_stats

torch.set_num_threads(1)

B, S = 2, 32
# one reduced config a family
FAMILIES = ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "rwkv6-7b",
            "hubert-xlarge"]


def _v5e_hw() -> roof.HW:
    """The reference's V5E figures in the port's terms: ICI (rate times
    links) as the in-node link, DCN as the network."""
    v = ref_roof.V5E
    return roof.HW(peak_flops=v.peak_flops, hbm_bw=v.hbm_bw,
                   nvlink_bw=v.ici_bw * v.ici_links, node_ranks=256,
                   net_bw=v.dcn_bw)


@pytest.mark.parametrize("counts", [(3.1e12, 7.7e10, 2.5e8, 0.0),
                                    (1.0e9, 4.0e11, 0.0, 6.0e9),
                                    (5.0e14, 1.0e10, 3.0e9, 2.0e9)])
def test_roofline_arithmetic_matches_reference(monkeypatch, counts):
    flops, traffic, near, far = counts
    monkeypatch.setattr(ref_roof.hlo_parse, "analyze",
                        lambda *a, **k: hlo_parse.HloStats(
                            flops=flops, traffic_bytes=traffic,
                            coll=dict(ici=near, dcn=far)))
    want = ref_roof.roofline(arch="a", cell="c", mesh_name="m", chips=4,
                             cost={}, hlo_text="", model_flops=2.0e12)
    stats = op_stats.OpStats(flops=flops, traffic_bytes=traffic)
    stats.coll.update(nvlink=near, network=far)
    got = roof.roofline(arch="a", cell="c", mesh_name="m", ranks=4,
                        stats=stats, model_flops=2.0e12, hw=_v5e_hw())
    for k in ("compute_s", "memory_s", "collective_s", "bound_s",
              "useful_flop_ratio", "roofline_fraction"):
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                rel=1e-12), k
    assert got.dominant == want.dominant
    assert got.row() == want.row()


def test_h100_constants():
    """The datasheet figures, one source for chip_smoke.py's bounds."""
    assert roof.HBM_BYTES_PER_S == roof.H100.hbm_bw == 3.35e12
    assert roof.BF16_FLOPS_PER_S == roof.H100.peak_flops == 989e12
    assert (roof.H100.nvlink_bw, roof.H100.node_ranks,
            roof.H100.net_bw) == (450e9, 8, 50e9)


def _inputs(cfg, meta: bool):
    dev = "meta" if meta else None
    if cfg.frontend != "none":
        shape, dtype = (B, S, cfg.d_model), torch.float32
    else:
        shape, dtype = (B, S), torch.int32
    if meta:
        return torch.empty(shape, dtype=dtype, device=dev)
    r = np.random.RandomState(0)
    if cfg.frontend != "none":
        return jnp.asarray(r.randn(*shape).astype(np.float32))
    return jnp.asarray(r.randint(0, cfg.vocab, shape).astype(np.int32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_flops_match_hlo_parse(arch):
    """Every dot of the reference's compiled forward is a matmul here:
    the same FLOPs within 1 % (both count 2·m·n·k a product). They are
    equal but for the MoE family, where the reference counts
    2·tokens·top_k·experts more a layer (2,048 of 113.5 M at
    phi3.5-moe-reduced): it builds the combine weights with a dot,
    ``einsum("bsk,bske->bse", weights, onehot)``, where the port
    scatters them."""
    rcfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    params = ref_tf.init_params(rcfg, jax.random.key(0))
    hlo = jax.jit(lambda p, t: ref_tf.forward(p, rcfg, t)).lower(
        params, _inputs(rcfg, False)).compile().as_text()
    want = hlo_parse.analyze(hlo).flops
    got = op_stats.analyze(
        lambda p, t: tf.forward(p, cfg, t, backend="torch"),
        tf.init_params(cfg, device="meta"), _inputs(cfg, True)).flops
    assert want > 0
    assert got == pytest.approx(want, rel=0.01), (got, want)


def test_recorder_bytes_and_links():
    """Hand-counted: on a 2 x 16 grid of 8-GPU nodes, ``model`` groups of
    16 span two nodes (network), a ``pod`` pair spans nodes too, and the
    bytes are a rank's whole message (the gathered output, the scattered
    input)."""
    grid = NamedGrid(("pod", "model"), (2, 16))
    rec = op_stats.PlanRecorder(grid, node_ranks=8)
    model = rec.communicator("model")
    assert model.ranks == list(range(16))
    stats = op_stats.analyze(
        lambda x: (model.compile("all_gather", (4, 256), torch.bfloat16)(x),
                   model.compile("reduce_scatter", (64, 256),
                                 torch.float32)(x.float().repeat(1, 16, 1)),
                   model.compile("all_reduce", (4, 256),
                                 torch.bfloat16)(x)),
        torch.empty((1, 4, 256), dtype=torch.bfloat16, device="meta"),
        recorder=rec)
    assert [c["bytes"] for c in stats.calls] == [
        16 * 4 * 256 * 2, 64 * 256 * 4, 4 * 256 * 2]
    assert stats.coll["network"] == sum(c["bytes"] for c in stats.calls)
    assert stats.coll["nvlink"] == 0
    small = NamedGrid(("data", "model"), (4, 2))
    rec = op_stats.PlanRecorder(small, node_ranks=8)
    assert roof.collective_bytes([dict(
        collective="all_reduce", bytes=100,
        ranks=rec.communicator("data").ranks)], node_ranks=8) == dict(
        dict.fromkeys(roof.COLLECTIVES, 0), all_reduce=100, nvlink=100,
        network=0)


def test_op_stats_counts_a_matmul_and_its_peak():
    """One (64, 128) @ (128, 32) f32 product: 2·64·128·32 FLOPs, its
    operands and result as traffic, and the result on top of the inputs
    at the peak."""
    a = torch.empty((64, 128), device="meta")
    w = torch.empty((128, 32), device="meta")
    stats = op_stats.analyze(lambda a, w: a @ w, a, w)
    assert stats.flops == 2 * 64 * 128 * 32
    assert stats.traffic_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert stats.peak_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


@pytest.mark.parametrize("cell", ["decode_32k", "train_4k", "prefill_32k"])
def test_run_cell_on_a_small_grid(cell):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "qwen3-1.7b")), max_seq=1 << 16)
    grid = NamedGrid(("data", "model"), (2, 2))
    r = dryrun.run_cell("qwen3-1.7b", cell, cfg=cfg, grid=grid, save=False)
    assert r["ok"] and r["fits"] and r["ranks"] == 4
    assert r["memory"]["peak_bytes"] > 0 and r["op_flops"] > 0
    rf = r["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert 0 < rf["roofline_fraction"] <= 1
    assert r["plan_calls"] > 0
    kind = configs.SHAPES[cell]["kind"]
    assert r["layout"].startswith(kind)
    # a 2 x 2 grid sits in one node: every byte rides NVLink
    assert not r["collectives"]["network"] and r["collectives"]["nvlink"]
    if kind == "train":
        # remat: the forward twice and the backward once, 4/3 of 6·N·D's
        # matmul work at most
        assert 0.7 < rf["useful_flop_ratio"] < 1.0


def test_list_prints_the_reference_cells(capsys):
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [tuple(line.split()) for line in lines] == \
        ref_configs.all_cells()
