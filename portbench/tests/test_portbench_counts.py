"""The benchmark's own FLOP and byte counts against hand arithmetic."""
import json

import pytest

from portbench_helpers import BENCH
from harness import counts


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


#: the hybrid family at hymba-1.5b's sizes as the port holds them (the SSM
#: head's inner width d_model): no cell of the benchmark runs it yet
HYMBA = {"family": "hybrid", "n_layers": 32, "d_model": 1600,
         "n_heads": 25, "n_kv_heads": 5, "head_dim": 64, "d_ff": 5504,
         "vocab": 32001, "window": 1024, "pad_heads_to": 40,
         "dtype": "bfloat16",
         "ssm": {"state_dim": 16, "dt_rank": 100}}


def test_phi_flops_by_hand():
    c = _cfg("phi35moe-12l-tp4")
    d, f, hd = 4096, 6400, 128
    attn = d * 32 * hd + 2 * d * 8 * hd + 32 * hd * d
    moe = d * 16 + 2 * 3 * d * f                      # router + top-2
    assert counts.layer_params(c) == attn + moe
    # one token at position 99: 12 layers, 100 keys
    ctx = counts.context_sums(c, [99], [1])
    assert ctx == {"rows": 1, None: 100}
    want = 2.0 * (attn + moe) * 12 + 4.0 * 32 * hd * 100 * 12
    assert counts.position_flops(c, ctx) == pytest.approx(want)
    assert counts.logits_flops(c, 3) == 2.0 * d * 32064 * 3


def test_hymba_flops_and_window_by_hand():
    c = HYMBA
    d, f = 1600, 5504
    attn = d * 25 * 64 + 2 * d * 5 * 64 + 25 * 64 * d  # published heads
    ssm = d * 2 * d + d * (32 + 100) + 100 * d + d * d
    assert counts.layer_params(c) == attn + 3 * d * f + ssm
    # positions 1020..1029 against the window of 1024: 1021, ..., 1024,
    # then 1024 six times
    ctx = counts.context_sums(c, [1020], [10])
    assert ctx[1024] == 1021 + 1022 + 1023 + 1024 + 6 * 1024
    assert ctx["rows"] == 10


def test_plan_bytes_count_routed_rows_only():
    c = _cfg("phi35moe-12l-tp4")
    rows, tp, d, k = 30, 4, 4096, 2
    b = counts.plan_bytes(c, tp=tp, rows=rows, decode=True)
    # 12 layer AllReduce + the embedding's gather-reduce: in and out a rank
    assert b["all_reduce"] == 13 * 2 * tp * rows * d * 2
    # dispatch and combine a layer over the routed rows (tokens x top-2)
    assert b["all_to_all"] == 12 * 2 * (2 * tp * rows * k * d * 2)
    # f32 logits: each rank reads its rows x v/tp, writes all ranks'
    assert b["all_gather"] == tp * rows * (32064 // tp) * 4 * (1 + tp)
    assert "all_gather" not in counts.plan_bytes(c, tp=tp, rows=rows,
                                                 decode=False)


def test_hymba_plan_bytes_96_allreduce_a_step():
    c = HYMBA
    b = counts.plan_bytes(c, tp=4, rows=7, decode=True)
    # vocab 32001 does not divide: no vocab-sharded gather, no AllGather
    assert b == {"all_reduce": 96 * 2 * 4 * 7 * 1600 * 2}
