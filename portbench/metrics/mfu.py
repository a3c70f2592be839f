"""The whole serving step's share of the card's bf16 peak over the
window: the model FLOPs of every position the window's steps carried
(prompt and output tokens, ``harness/counts``) and of the logits of
every token emitted, over the window's seconds times the peak (%)."""
from harness import counts
from metrics._stats import in_window


def read(run, name):
    if run.peaks is None:
        return None
    flops = sum(counts.position_flops(run.config, r.ctx)
                for r in run.records)
    emitted = sum(len(in_window(t.stamps)) for t in run.tracks.values())
    flops += counts.logits_flops(run.config, emitted)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])
