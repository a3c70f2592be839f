"""Open loop: requests due on a fixed schedule, sent whether or not the
earlier ones have finished, as independent users send them. Each is
timed from when it was due, so a stall shows in the requests behind it;
``Track.submitted - Track.due`` is how late the generator ran."""
from __future__ import annotations

from harness import traffic as traffic_lib


def drive(session, traffic: dict, vocab: int, seed: int) -> None:
    pool = traffic_lib.requests(traffic, vocab, seed)
    due = traffic_lib.arrivals(traffic, seed)
    session.open()
    i = 0
    while not session.closed:
        now = session.now()
        while i < len(pool) and due[i] <= min(now, session.seconds):
            session.submit(pool[i], float(due[i]))
            i += 1
        if session.idle():
            if i >= len(pool):
                raise RuntimeError("the arrival schedule ended inside the "
                                   "window: make the traffic's pool larger")
            session.wait_until(float(due[i]))
            continue
        session.tick()
