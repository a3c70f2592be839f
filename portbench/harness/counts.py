"""The work a step needs, counted from its shapes: the model's FLOPs and
the bytes its collectives must move. These count the model's work,
whatever implements it: padded heads, padded slot buckets and the MoE
dispatch's padded capacity are not counted, so a later change that
trims padding reads as a gain.

FLOPs: 2 a multiply-add of every matrix a position passes through (the
published heads; for MoE the router and ``top_k`` experts), attention's
``q k`` and ``p v`` products over the keys a position sees (its window
at most), the SSM recurrence's ``6 d_inner state`` a position, and the
unembedding for each position whose logits are read (an emitted token).

Bytes: each rank's input read once and its output written once:
AllReduce ``2 tp rows d``, all_to_all over the routed rows alone ``2 tp
rows top_k d``, the logits AllGather ``tp rows v/tp (1 + tp)`` in f32.
"""
from __future__ import annotations

from harness import weights


def layer_windows(config: dict) -> list:
    """Each layer's attention window (None: global), by period slot,
    the program's rule: ``window`` on every slot of a period but its last,
    which is global, or on the one slot when the period is 1."""
    per, _ = weights.groups(config)
    w = config.get("window")
    return [w] * (per - 1) + [None] if per > 1 else [w]


def layer_params(config: dict) -> int:
    """Matrix parameters one position multiplies through in one layer."""
    d, hd = config["d_model"], weights.head_dim(config)
    nh, nkv = config["n_heads"], config["n_kv_heads"]
    n = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    if config["family"] == "moe":
        m = config["moe"]
        f = m.get("d_ff_expert") or config["d_ff"]
        n += d * m["num_experts"] + m["top_k"] * 3 * d * f
    else:
        n += 3 * d * config["d_ff"]
    if config["family"] == "hybrid":
        s, r = config["ssm"]["state_dim"], weights.dt_rank(config)
        n += d * 2 * d + d * (2 * s + r) + r * d + d * d
    return n


def position_flops(config: dict, ctx_by_window: dict) -> float:
    """FLOPs of the layers over positions whose context lengths summed,
    clipped to each window, give ``ctx_by_window`` {window: sum}, and
    ``rows`` under the key ``"rows"``."""
    rows = ctx_by_window["rows"]
    per, n_groups = weights.groups(config)
    hd, nh = weights.head_dim(config), config["n_heads"]
    f = 2.0 * layer_params(config) * config["n_layers"] * rows
    for w in layer_windows(config):
        f += 4.0 * nh * hd * ctx_by_window[w] * n_groups
    if config["family"] == "hybrid":
        f += 6.0 * config["d_model"] * config["ssm"]["state_dim"] * \
            config["n_layers"] * rows
    return f


def logits_flops(config: dict, tokens: int) -> float:
    return 2.0 * config["d_model"] * config["vocab"] * tokens


def context_sums(config: dict, starts, counts) -> dict:
    """{"rows": positions, window: sum of min(pos + 1, window)} over rows
    whose ``counts[i]`` positions start at ``starts[i]``."""
    out = {"rows": 0}
    for w in layer_windows(config):
        out[w] = 0
    for p0, n in zip(starts, counts):
        p0, n = int(p0), int(n)
        if n <= 0:
            continue
        out["rows"] += n
        for w in out:
            if w == "rows":
                continue
            # sum over j < n of min(p0 + j + 1, w)
            hi = p0 + n
            if w is None or hi <= w:
                out[w] += n * (p0 + 1) + n * (n - 1) // 2
            else:
                k = max(0, min(n, w - p0))      # positions below the cap
                out[w] += k * (p0 + 1) + k * (k - 1) // 2 + (n - k) * w
    return out


def plan_bytes(config: dict, *, tp: int, rows: int, decode: bool) -> dict:
    """{collective: bytes} the plans of one step over ``rows`` real rows
    must move: a decode step (``decode``: with the logits AllGather) or
    a fused prefill step."""
    esize = 2 if config["dtype"] in ("bfloat16", "float16") else 4
    d, v, fam = config["d_model"], config["vocab"], config["family"]
    split = v % tp == 0
    n_ar = config["n_layers"] * {"moe": 1, "hybrid": 3}.get(fam, 2)
    n_ar += 1 if split else 0                 # the embedding's gather
    out = {"all_reduce": n_ar * 2 * tp * rows * d * esize}
    if fam == "moe" and config["moe"]["num_experts"] % tp == 0:
        k = config["moe"]["top_k"]
        out["all_to_all"] = config["n_layers"] * 2 * (2 * tp * rows * k * d
                                                      * esize)
    if decode and split:
        out["all_gather"] = tp * rows * (v // tp) * 4 * (1 + tp)
    return out
