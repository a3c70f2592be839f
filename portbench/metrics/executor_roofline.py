"""The executor kernel's share of its roofline over the profiled ticks:
the bytes the replayed plans must move (``harness/counts.plan_bytes``
over each step's real rows: the routed rows alone for all_to_all) over
the card's HBM bandwidth, over the executor kernels' device time in the
profile (%)."""
from harness import counts


def read(run, name):
    if run.trace is None or run.peaks is None or not run.trace["executor_s"]:
        return None
    tp = run.config["serving"]["tp"]
    total = 0
    for r in run.records:
        if run.in_profile(r):
            total += sum(counts.plan_bytes(
                run.config, tp=tp, rows=r.rows,
                decode=r.kind == "decode").values())
    bound_s = total / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / run.trace["executor_s"]
