"""Device time of the window's fused prefill steps (CUDA events around
``Scheduler.run_prefill``, which dispatches the step eagerly) over the
prompt tokens they consumed (us a token)."""


def read(run, name):
    recs = [r for r in run.records if r.kind == "prefill" and r.events]
    tokens = sum(r.rows for r in recs)
    if not tokens:
        return None
    ms = sum(r.events[0].elapsed_time(r.events[1]) for r in recs)
    return ms * 1e3 / tokens
