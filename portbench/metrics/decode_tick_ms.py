"""Mean device time of one decode step (a slot bucket's graph replay,
the token-by-token prefill's micro-steps among them): CUDA events around
``Scheduler.run_step``, over every replay of the window (ms)."""


def read(run, name):
    ms = [r.events[0].elapsed_time(r.events[1]) for r in run.records
          if r.kind == "decode" and r.events]
    return sum(ms) / len(ms) if ms else None
