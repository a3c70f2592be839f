"""The dry run: every (arch × cell) of the production grids traced on
fake tensors, its per-rank peak held against one card, its roofline on
the H100's constants (port of ``repro.launch.dryrun``).

Nothing here touches a device: each cell's step is built as the port
runs it and run under ``FakeTensorMode`` (:mod:`repro_torch.roofline.
op_stats`), its plans swapped for a recorder. No ``XLA_FLAGS``, no jax.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --cell decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results land in ``experiments/dryrun_torch/<arch>__<cell>__<mesh>
[__<mode>].json``. The port's layout of a cell (``layout`` in the JSON):

* **decode** — the explicit TP decode step, the main path: TP over
  ``model``, the global batch's rows split over the data axes (``pod`` ×
  ``data``), one data replica traced rank-stacked and its counts divided
  by the ``model`` size. A config the explicit step refuses (rwkv6, heads
  that do not divide) is traced as the auto step on one rank, as the
  port then serves it;
* **train** — the explicit FSDP trainer over every rank of the grid:
  ``data`` × ``model`` merged into one FSDP axis (the port's trainer has
  no TP), ``pod`` a second DP axis. Only the explicit trainer has ranks,
  so a train cell traces it whatever ``--mode`` says. One rank's pass
  and the plans around it are traced: the ranks are symmetric;
* **prefill** — the FSDP prefill step over the data axes alone (the
  port's prefill has no TP), one rank traced.

The rwkv6 family's train and prefill cells are traced at two short
lengths (:data:`LOOP_SEQS`) and extended along the sequence
(``extended_from_seq`` in the JSON): its WKV recurrence is a loop over
tokens, which a trace would walk some 10^5 times.

A cell the layout cannot run (a batch that does not split over its
ranks) reports ``ok: false`` and why; a cell whose per-rank peak exceeds
one card reports ``fits: false`` with its bytes. Both are findings, not
errors.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step as step_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.mesh import NamedGrid, RankAxis
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import op_stats
from repro_torch.train import optimizer as opt

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

__all__ = ["input_specs", "model_flops", "OPTIMIZATIONS", "lower_cell",
           "run_cell", "main", "OUT_DIR"]


def input_specs(arch: str, cell: str, cfg=None, shape=None):
    """``meta`` stand-ins for every model input of a cell (no storage):
    tokens (int32, or bf16 frames for a frontend arch outside decode),
    labels and the params. ``shape`` replaces the cell's
    ``configs.SHAPES`` entry."""
    cfg = cfg or configs.get_config(arch)
    shp = shape or configs.SHAPES[cell]
    b, s = shp["global_batch"], shp["seq_len"]
    if cfg.frontend != "none" and shp["kind"] != "decode":
        tokens = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                             device="meta")
    else:
        tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    labels = torch.empty((b, s), dtype=torch.int32, device="meta")
    params = tf.init_params(cfg, device="meta")
    return cfg, dict(tokens=tokens, labels=labels, params=params, batch=b,
                     seq=s, kind=shp["kind"])


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Useful FLOPs: 6·N·D (+ attention scores) for train, 2·N·D for
    inference; windows cap the quadratic term (the reference's count)."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    attn_prefill = attn_decode = 0.0
    if cfg.family != "rwkv6":
        wins = [w if w is not None else seq for w in tf.layer_windows(cfg)]
        layers_per_win = cfg.n_layers / len(wins)
        attn_prefill = sum(2.0 * 2.0 * seq * min(seq, w) * cfg.n_heads
                           * cfg.hd for w in wins) * layers_per_win * batch
        attn_decode = sum(2.0 * 2.0 * min(seq, w) * cfg.n_heads * cfg.hd
                          for w in wins) * layers_per_win * batch
    if kind == "train":
        return 6.0 * n * batch * seq + 3.0 * attn_prefill
    if kind == "prefill":
        return 2.0 * n * batch * seq + attn_prefill
    return 2.0 * n * batch + attn_decode


#: the reference's per-arch bundles (``--opt``), every field one the
#: port's config, serve step or train step takes
OPTIMIZATIONS = {
    "llama3.2-3b": dict(pad_heads_to=48, attn_chunk=2048),
    "hymba-1.5b": dict(pad_heads_to=80),
    "mixtral-8x22b": dict(mode="explicit", dp_wire_dtype="bfloat16"),
    "internvl2-76b": dict(kv_quant=True),
}


def _mesh_name(grid: NamedGrid) -> str:
    return "x".join(map(str, grid.axis_sizes))


def _data_axes(grid: NamedGrid) -> tuple:
    return tuple(a for a in ("pod", "data") if a in grid.shape)


def _train_grid(grid: NamedGrid) -> NamedGrid:
    """The train cell's DP grid: ``data`` × ``model`` as one FSDP axis
    ``data`` (row-major, so rank ids stay the grid's), ``pod`` kept."""
    n = grid.shape.get("data", 1) * grid.shape.get("model", 1)
    if "pod" in grid.shape:
        return NamedGrid(("pod", "data"), (grid.shape["pod"], n))
    return NamedGrid(("data",), (n,))


def _dp_comms(recorder, grid: NamedGrid) -> dict:
    if len(grid.axis_names) == 2:
        return {"node": recorder.communicator(grid.axis_names[0]),
                "local": recorder.communicator(grid.axis_names[1])}
    return {"flat": recorder.communicator(grid.axis_names[0])}


@dataclasses.dataclass
class Lowered:
    """A cell's step, ready for :func:`op_stats.analyze`: ``prepare(
    params)`` builds it on fake tensors and returns its arguments, the
    step first; counts over ``divide`` are a rank's."""
    layout: str
    prepare: object
    recorder: op_stats.PlanRecorder
    divide: int
    active_ranks: int
    error: Optional[str] = None


def _expanded(shape, dtype, device):
    """A batch stand-in of one row's storage (the traced rank reads its
    own rows; the others' would only pad the peak)."""
    return torch.zeros((1,) + tuple(shape[1:]), dtype=dtype,
                       device=device).expand(tuple(shape))


def lower_cell(arch: str, cell: str, *, multi_pod: bool = False,
               mode: str = "auto", apply_opt: bool = False, cfg=None,
               grid: Optional[NamedGrid] = None, shape=None,
               one_rank: bool = True):
    """(grid, cfg, specs, :class:`Lowered`) of one cell. ``cfg``/``grid``/
    ``shape`` replace the arch's config, the production grid and the
    cell's shape (the tests run reduced configs on small grids;
    ``chip_smoke.py`` the card's own steps). ``one_rank=False`` traces
    every DP rank of a train or prefill cell stacked on one device, as
    the card runs them, in place of one rank's pass."""
    grid = grid or make_production_mesh(multi_pod=multi_pod)
    cfg, specs = input_specs(arch, cell, cfg, shape)
    kind = specs["kind"]
    bundle = OPTIMIZATIONS.get(arch, {}) if apply_opt else {}
    kv_quant = bool(bundle.get("kv_quant"))
    wire = torch.bfloat16 if bundle.get("dp_wire_dtype") == "bfloat16" \
        else None
    over = {k: bundle[k] for k in ("pad_heads_to", "attn_chunk")
            if k in bundle}
    if over:
        cfg = dataclasses.replace(cfg, **over)
        specs["params"] = tf.init_params(cfg, device="meta")
    b, s = specs["batch"], specs["seq"]
    dev = "cpu"

    if kind == "decode":
        tp = grid.shape.get("model", 1)
        dp = 1
        for a in _data_axes(grid):
            dp *= grid.shape[a]
        rows = b // dp if b % dp == 0 and b >= dp else b
        ok, why = shd.explicit_decode_supported(cfg, tp)
        recorder = op_stats.PlanRecorder(grid)
        smode = "explicit" if ok else "auto"

        def prepare(params):
            axis = RankAxis("model", tp if ok else 1, dev)
            kw = {}
            if ok:
                comm = recorder.communicator("model")
                kw = dict(comm=comm, plans=step_mod.compile_decode_plans(
                    cfg, comm, batch_local=rows, tp=tp))
            step, lay = step_mod.make_serve_step(
                cfg, axis, batch=rows, max_kv=s, mode=smode,
                kv_quant=kv_quant, **kw)
            return (step, lay.params(params), lay.cache(),
                    torch.zeros(rows, dtype=torch.long, device=dev),
                    min(s, cfg.max_seq) - 1)

        layout = (f"decode: explicit TP {tp} over model, {rows} rows a "
                  f"replica over {dp} data replicas; one replica traced "
                  f"rank-stacked, counts over {tp}" if ok else
                  f"decode: auto on one rank, {rows} rows (explicit "
                  f"refused: {why})")
        return grid, cfg, specs, Lowered(layout, prepare, recorder,
                                         tp if ok else 1, tp * dp)

    if kind == "train":
        tgrid = _train_grid(grid)
        ndp = tgrid.size
        recorder = op_stats.PlanRecorder(tgrid)
        traced = ("one rank traced" if one_rank
                  else "every rank traced stacked")
        layout = (f"train: explicit FSDP over {ndp} DP ranks "
                  f"({'x'.join(map(str, tgrid.axis_sizes))}: data x model "
                  f"as one FSDP axis), {traced} (whatever --mode)")
        if b % ndp:
            return grid, cfg, specs, Lowered(
                layout, None, recorder, 1, ndp,
                error=f"a global batch of {b} does not split over {ndp} "
                      f"DP ranks")

        def prepare(params):
            axes = tgrid.rank_axes(dev)
            step = step_mod.make_train_step(
                cfg, axes, opt.AdamWConfig(), mode="explicit",
                global_batch=b, seq_len=s, fsdp=True,
                dp_comms=_dp_comms(recorder, tgrid), device=dev,
                fsdp_ranks=(0,) if one_rank else None, dp_wire_dtype=wire)
            held = step.fsdp.layout.empty(dev)
            batch = dict(tokens=_expanded(specs["tokens"].shape,
                                          specs["tokens"].dtype, dev),
                         labels=_expanded((b, s), torch.int32, dev))
            return step, held, opt.adamw_init(held), batch

        return grid, cfg, specs, Lowered(layout, prepare, recorder, 1, ndp)

    # prefill
    daxes = _data_axes(grid)
    pgrid = NamedGrid(daxes, tuple(grid.shape[a] for a in daxes))
    ndp = pgrid.size
    recorder = op_stats.PlanRecorder(pgrid)
    layout = (f"prefill: FSDP over the data axes ({ndp} ranks), no TP; "
              f"{'one rank traced' if one_rank else 'every rank traced'}")
    if b % ndp:
        return grid, cfg, specs, Lowered(
            layout, None, recorder, 1, ndp,
            error=f"a global batch of {b} does not split over {ndp} DP "
                  f"ranks")

    def prepare(params):
        step = step_mod.make_prefill_step(
            cfg, device=dev, dp_axes=pgrid.rank_axes(dev), fsdp=True,
            dp_comms=_dp_comms(recorder, pgrid),
            fsdp_ranks=(0,) if one_rank else None, backend="torch")
        return (step, step.fsdp.layout.empty(dev),
                _expanded(specs["tokens"].shape, specs["tokens"].dtype, dev))

    return grid, cfg, specs, Lowered(layout, prepare, recorder, 1, ndp)


#: the rwkv6 family's WKV recurrence is a loop over tokens (as the
#: reference's ``lax.scan``), which a trace walks token by token: its
#: train and prefill cells are traced at these two lengths and every
#: count is extended along the sequence, on which each is affine (the
#: loop's ops, FLOPs and bytes a token, the activations it keeps; the
#: weights, their state and the plan calls do not depend on it)
LOOP_SEQS = (32, 64)


def _trace(arch, cell, shape, **kw) -> tuple:
    grid, cfg, specs, low = lower_cell(arch, cell, shape=shape, **kw)
    if low.error is not None:
        return grid, cfg, specs, low, None
    stats = op_stats.analyze(lambda step, *a: step(*a), specs["params"],
                             prepare=low.prepare, recorder=low.recorder)
    return grid, cfg, specs, low, stats.per_rank(low.divide)


def _extend(a, b, s0, s1, s):
    """The counts at sequence length ``s`` from traces ``a`` (at ``s0``)
    and ``b`` (at ``s1``), each affine in the length."""
    f = (s - s0) / (s1 - s0)
    out = dataclasses.replace(b)
    out.flops = a.flops + (b.flops - a.flops) * f
    out.traffic_bytes = a.traffic_bytes + (b.traffic_bytes
                                           - a.traffic_bytes) * f
    out.peak_bytes = int(a.peak_bytes + (b.peak_bytes - a.peak_bytes) * f)
    return out


def _split(calls, node_ranks) -> dict:
    out = {"nvlink": {}, "network": {}}
    for c in calls:
        link = ("network" if roof.spans_nodes(c["ranks"], node_ranks)
                else "nvlink")
        out[link][c["collective"]] = out[link].get(c["collective"], 0) \
            + c["bytes"]
    return out


def run_cell(arch: str, cell: str, *, multi_pod: bool = False,
             mode: str = "auto", opt_bundle: bool = False, save: bool = True,
             cfg=None, grid: Optional[NamedGrid] = None) -> dict:
    """Trace one cell and write its JSON (with ``save``)."""
    t0 = time.time()
    kw = dict(multi_pod=multi_pod, mode=mode, apply_opt=opt_bundle, cfg=cfg,
              grid=grid)
    shp = dict(configs.SHAPES[cell])
    family = (cfg or configs.get_config(arch)).family
    extended = family == "rwkv6" and shp["kind"] != "decode"
    if extended:
        s0, s1 = LOOP_SEQS
        a = _trace(arch, cell, dict(shp, seq_len=s0), **kw)[4]
        grid, cfg, specs, low, b = _trace(arch, cell, dict(shp, seq_len=s1),
                                          **kw)
        stats = None if b is None else _extend(a, b, s0, s1, shp["seq_len"])
        specs.update(seq=shp["seq_len"])
    else:
        grid, cfg, specs, low, stats = _trace(arch, cell, None, **kw)
    mesh_name = _mesh_name(grid)
    kind = specs["kind"]
    result = {"arch": arch, "cell": cell, "mesh": mesh_name,
              "mode": "opt" if opt_bundle else mode, "ranks": grid.size,
              "active_ranks": low.active_ranks, "kind": kind,
              "layout": low.layout,
              "hw": dataclasses.asdict(roof.H100)}
    if extended:
        result["extended_from_seq"] = list(LOOP_SEQS)
    if low.error is not None:
        result.update(ok=False, fits=False, error=low.error,
                      trace_s=round(time.time() - t0, 2))
    else:
        trace_s = time.time() - t0
        mflops = model_flops(cfg, kind, specs["batch"], specs["seq"]) \
            / low.active_ranks
        rep = roof.roofline(arch=arch, cell=cell, mesh_name=mesh_name,
                            ranks=grid.size, stats=stats, model_flops=mflops)
        result.update(
            trace_s=round(trace_s, 2),
            memory={"peak_bytes": stats.peak_bytes,
                    "hbm_bytes": roof.H100.hbm_bytes},
            fits=stats.peak_bytes <= roof.H100.hbm_bytes,
            collectives=_split(stats.calls, low.recorder.node_ranks),
            plan_calls=len(stats.calls),
            op_flops=stats.flops, op_traffic_bytes=stats.traffic_bytes,
            roofline={
                "compute_s": rep.compute_s, "memory_s": rep.memory_s,
                "collective_s": rep.collective_s, "dominant": rep.dominant,
                "useful_flop_ratio": rep.useful_flop_ratio,
                "roofline_fraction": rep.roofline_fraction,
                "model_flops_per_rank": rep.model_flops},
            ok=True)
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "__opt" if opt_bundle else (f"__{mode}" if mode != "auto"
                                             else "")
        out = OUT_DIR / f"{arch}__{cell}__{mesh_name}{suffix}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="auto", choices=["auto", "explicit"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the per-arch optimization bundle")
    args = ap.parse_args(argv)

    if args.list:
        for a, c in configs.all_cells():
            print(f"{a:24s} {c}")
        return

    cells = configs.all_cells() if args.all else [(args.arch, args.cell)]
    failures = []
    for arch, cell in cells:
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
        suffix = f"__{args.mode}" if args.mode != "auto" else ""
        out = OUT_DIR / f"{arch}__{cell}__{mesh_name}{suffix}.json"
        if args.skip_existing and out.exists():
            print(f"[skip] {arch} {cell} {mesh_name}")
            continue
        try:
            r = run_cell(arch, cell, multi_pod=args.multi_pod, mode=args.mode,
                         opt_bundle=args.opt)
            if not r["ok"]:
                print(f"[no layout] {arch:24s} {cell:12s} {mesh_name:8s} "
                      f"{r['error']}")
                continue
            rf = r["roofline"]
            print(f"[ok] {arch:24s} {cell:12s} {mesh_name:8s} "
                  f"trace={r['trace_s']:.1f}s "
                  f"peak={r['memory']['peak_bytes'] / 1e9:.2f}GB "
                  f"fits={r['fits']} dominant={rf['dominant']:10s} "
                  f"frac={rf['roofline_fraction']:.2f}")
        except Exception as e:
            failures.append((arch, cell, str(e)))
            print(f"[FAIL] {arch} {cell}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(f"{a}/{c}" for a, c, _ in failures))


if __name__ == "__main__":
    main()
