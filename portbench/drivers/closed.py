"""Closed loop: ``clients`` clients, each with one request in flight,
sending its next the moment its last one finishes. A slow system
receives less load, as callers that each wait for a reply give it
(chat and batch-API back ends that keep a fixed number of requests in
flight).

The window opens on the loop in its steady state, not on an empty
system. In set-up, one client a slot sends its first request with its
output cut to a share of its length, as though that request were that
far through its life: the shares are spread evenly over (0, 1], one a
slot, in an order drawn from the seed. The loop then runs
until every one of them has its first token: every slot is then
decoding, and their ends, and so the admissions that follow them, are
spread over the window. The window then opens and the other clients
send their first requests."""
from __future__ import annotations

import numpy as np

from harness import traffic as traffic_lib


def drive(session, traffic: dict, vocab: int, seed: int) -> None:
    n = int(traffic["clients"])
    pool = traffic_lib.requests(traffic, vocab, seed)
    queues = [pool[c::n] for c in range(n)]
    first = min(n, session.slots)
    share = (np.random.default_rng([seed, 3]).permutation(first) + 1.0) \
        / first
    owner, waiting = {}, []
    for c in range(first):
        r = queues[c].pop(0)
        r = traffic_lib.Req(r.prompt,
                            max(1, int(np.ceil(share[c] * r.max_new))))
        owner[session.submit(r, 0.0)] = c
    # set-up: every slot past its prefill; a client whose first request
    # ends meanwhile sends its next when the window opens
    while any(not session.tracks[rid].stamps for rid in owner):
        waiting += [owner.pop(rid) for rid in session.tick()]
    session.open()
    for c in waiting + list(range(first, n)):
        owner[session.submit(_next(queues, c), 0.0)] = c
    while not session.closed:
        for rid in session.tick():
            c = owner.pop(rid)
            due = session.tracks[rid].stamps[-1]
            owner[session.submit(_next(queues, c), due)] = c


def _next(queues: list, c: int):
    if not queues[c]:
        raise RuntimeError(f"client {c} ran out of requests: make the "
                           f"traffic's pool larger")
    return queues[c].pop(0)
