"""Whether what the window served is right: a sample of the requests it
finished, drawn from the seed with the longest among them, served tokens
``check.tokens`` or more in all from ``check.requests`` requests or more
(1 by default), run once through the family's plain
float32 reference (``reference/<family>.py``) over each prompt and its
served tokens. At each served token the reference's best logit minus
its logit of the token served is that token's gap (0 where the program
served the reference's own choice); the statistics of those gaps that
the configuration's ``check`` gives a limit (:func:`numbers`) are
compared with their limits.

The reference runs after the program's state is freed, on weights it
makes again from the seed (``harness/weights.py``), with TF32 off."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from harness import weights


def sample(tracks: dict, tokens: int, seed: int, requests: int = 1) -> list:
    """The finished requests to check: the one that served the most
    tokens, then others in an order drawn from ``seed`` until the sample
    holds ``tokens`` served tokens and ``requests`` requests (or every
    finished request)."""
    done = sorted((t for t in tracks.values() if t.done),
                  key=lambda t: t.rid)
    if not done:
        return []
    first = max(done, key=lambda t: (len(t.tokens), -t.rid))
    rest = [t for t in done if t is not first]
    order = np.random.default_rng([seed, 2]).permutation(len(rest))
    out, n = [first], len(first.tokens)
    for i in order:
        if n >= tokens and len(out) >= requests:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def sequences(picked: list, device) -> tuple:
    """(token sequences, first logit position) of the sample: each prompt
    followed by its served tokens but the last, the reference's logits
    read from the prompt's last position on."""
    seqs = [torch.as_tensor(np.concatenate([t.prompt, t.tokens[:-1]]),
                            dtype=torch.long, device=device) for t in picked]
    return seqs, [len(t.prompt) - 1 for t in picked]


def reference_logits(config: dict, seed: int, seqs, starts, device, *,
                     precision: str = "f32") -> list:
    ref = importlib.import_module(f"reference.{config['family']}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.make(config, seed, device)
        with torch.no_grad():
            return ref.logits(params, config, seqs, starts,
                              precision=precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def gaps(ref: list, served: list) -> np.ndarray:
    """Each served token's gap below the reference's best logit."""
    out = []
    for lg, toks in zip(ref, served):
        t = torch.as_tensor(toks, dtype=torch.long, device=lg.device)
        out.append((lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
                   .cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def _worst(g: np.ndarray, picked: list) -> list:
    """(request's prompt length, served token index, gap) of the widest
    gap."""
    i = int(g.argmax())
    for t in picked:
        if i < len(t.tokens):
            return [len(t.prompt), i, float(g.max())]
        i -= len(t.tokens)
    return []


def numbers(g: np.ndarray, chk: dict) -> dict:
    """The statistics of the served tokens' gaps that a configuration's
    ``check`` may hold a limit for: the widest gap, the mean gap, and the
    share of tokens more than ``off_margin`` below the reference's best
    (bf16 rounding flips near-ties, whose gaps are small; a fault or a
    lower precision moves tokens further)."""
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "off_share": float(np.mean(g > chk.get("off_margin", 0.05)))}


def verdict(got: dict, chk: dict) -> tuple:
    """({name: {"value", "limit"}}, ok) of the numbers ``got`` that the
    configuration's ``check`` gives a limit: ok where each is finite and
    within its limit."""
    checks = {k: {"value": v, "limit": chk[k]} for k, v in got.items()
              if k in chk}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, bool(ok)


def judge(config: dict, seed: int, tracks: dict, device, *,
          control: bool = False) -> dict:
    """The check's numbers, each with its limit, and ``ok``.
    ``control`` adds the control's numbers and its own verdict by the
    same limits (``control.py``; the benchmark's runs leave it out): the
    reference again with every weight product in fp8, its first choice
    at each served position read at its gap under the float32
    reference."""
    chk = config["check"]
    picked = sample(tracks, chk["tokens"], seed, chk.get("requests", 1))
    if not picked:
        return {"ok": False, "checks": {"requests_checked": {
            "value": 0, "limit": 1}}}
    seqs, starts = sequences(picked, device)
    ref = reference_logits(config, seed, seqs, starts, device)
    g = gaps(ref, [t.tokens for t in picked])
    n = int(sum(len(t.tokens) for t in picked))
    got = numbers(g, chk)
    checks, ok = verdict(got, chk)
    checks["tokens_checked"] = {"value": n, "limit": 1}
    checks["requests_checked"] = {"value": len(picked), "limit": 1}
    out = {"ok": ok, "checks": checks,
           "spread": dict(got, p99=float(np.percentile(g, 99)),
                          matched=float(np.mean(g == 0)),
                          worst_at=_worst(g, picked))}
    if control:
        low = reference_logits(config, seed, seqs, starts, device,
                               precision="fp8")
        cg = gaps(ref, [lg.argmax(-1).cpu().numpy() for lg in low])
        out["control"] = numbers(cg, chk)
        out["control_ok"] = verdict(out["control"], chk)[1]
    return out
