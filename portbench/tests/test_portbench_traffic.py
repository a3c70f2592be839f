"""The traffic a seed makes, and the end-to-end metrics taken over the
whole window: a stall planted in a window moves each of them."""
import json

import numpy as np
import pytest

from portbench_helpers import BENCH, DATA
from harness import bench, serving
from harness import traffic as traffic_lib


def _mix(name):
    for d in (BENCH / "traffic", DATA / "traffic"):
        if (d / f"{name}.json").exists():
            return json.loads((d / f"{name}.json").read_text())
    raise FileNotFoundError(name)


@pytest.mark.parametrize("name", ["chat-closed64", "tiny-closed",
                                  "tiny-open"])
def test_same_seed_same_traffic_every_seed_same_work(name):
    t = _mix(name)
    a = traffic_lib.requests(t, 32000, 2**31 + 5)
    b = traffic_lib.requests(t, 32000, 2**31 + 5)
    c = traffic_lib.requests(t, 32000, 7)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    # the same pool of work for every seed: one multiset of sizes, the
    # whole pool in another order
    sizes = sorted((len(r.prompt), r.max_new) for r in a)
    assert sizes == sorted((len(r.prompt), r.max_new) for r in c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in a)
    assert all(t["output"]["min"] <= r.max_new <= t["output"]["max"]
               for r in a)


def test_open_loop_arrivals_same_gaps_in_another_order():
    t = _mix("tiny-open")
    a = traffic_lib.arrivals(t, 2**31 + 5)
    assert np.array_equal(a, traffic_lib.arrivals(t, 2**31 + 5))
    b = traffic_lib.arrivals(t, 99)
    assert not np.array_equal(a, b)
    assert np.allclose(sorted(np.diff(a, prepend=0)),
                       sorted(np.diff(b, prepend=0)))
    rate = t["arrivals"]["rate_rps"]
    assert abs(len(a) / a[-1] - rate) / rate < 0.15


def test_mix_fits_the_configured_cache():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in spec["configs"]}
    for w in spec["workloads"]:
        c = json.loads((BENCH.parent / files[w["config"]]).read_text())
        assert traffic_lib.longest(_mix(w["traffic"])) <= \
            c["serving"]["max_kv"]


def _window(stall_at=None, stall=0.0):
    """Synthetic window: 8 requests due 0.1 s apart, each served one
    token every 50 ms from 20 ms after it was due; a stall of ``stall``
    seconds at ``stall_at`` delays every token from then on."""
    tracks = {}
    for rid in range(8):
        due = 0.1 * rid
        stamps = due + 0.02 + 0.05 * np.arange(10)
        if stall_at is not None:
            stamps = np.where(stamps >= stall_at, stamps + stall, stamps)
        end = 1.2
        stamps = [float(s) for s in stamps if s <= end]
        tracks[rid] = serving.Track(rid, np.zeros(4, np.int32), 10, due,
                                    due, admitted=due + 0.01,
                                    stamps=stamps, tokens=[1] * len(stamps),
                                    done=len(stamps) == 10)
    return bench.RunData(config={}, window_s=1.2, tracks=tracks,
                         records=[], setup_s=1.0, peaks=None)


def _read(name, data):
    mod = bench._load(BENCH / "metrics" / f"{name.split('.')[0]}.py", name)
    return mod.read(data, name)


def test_metrics_are_over_the_whole_window():
    d = _window()
    assert _read("itl_p95_ms", d) == pytest.approx(50.0)
    assert _read("itl_p50_ms", d) == pytest.approx(50.0)


def test_a_warm_up_before_the_window_is_not_counted():
    """Tokens a driver served before the window opened (stamped below 0)
    count in no rate and in no gap."""
    d = _window()
    for rid in range(8, 16):
        d.tracks[rid] = serving.Track(
            rid, np.zeros(4, np.int32), 10, -3.0, -3.0, admitted=-3.0,
            stamps=[-2.5, -0.3, 0.01], tokens=[1, 1, 1])
    assert _read("itl_p95_ms", d) == pytest.approx(50.0)
    assert _read("itl_p50_ms", d) == pytest.approx(50.0)
    # and in no FLOP count: the window's tokens only
    d.config = {"family": "moe", "d_model": 8, "vocab": 10}
    d.peaks = {"bf16_flops": 1.0}
    assert _read("mfu", d) == pytest.approx(
        100.0 * 2 * 8 * 10 * 88 / 1.2)


class _Loop:
    """A stand-in session: ``slots`` slots, a request's prompt takes two
    ticks, then it emits one token a tick."""

    def __init__(self, slots):
        self.slots, self.tracks, self.queue, self.live = slots, {}, [], {}
        self.t, self.opened_at, self.ticks_open = 0.0, None, 0
        self.first_token_at_open = None

    def submit(self, req, due):
        rid = len(self.tracks)
        self.tracks[rid] = serving.Track(rid, req.prompt, req.max_new, due,
                                         self.t)
        self.queue.append(rid)
        return rid

    def open(self):
        self.opened_at = self.t
        self.first_token_at_open = {r: bool(self.tracks[r].stamps)
                                    for r in self.live}

    @property
    def closed(self):
        return self.opened_at is not None and self.ticks_open >= 200

    def tick(self):
        self.t += 1.0
        self.ticks_open += self.opened_at is not None
        while self.queue and len(self.live) < self.slots:
            self.live[self.queue.pop(0)] = -2
        done = []
        for rid in list(self.live):
            self.live[rid] += 1
            tr = self.tracks[rid]
            if self.live[rid] > 0:
                tr.stamps.append(self.t)
                tr.tokens.append(1)
                if len(tr.tokens) == tr.max_new:
                    tr.done = True
                    del self.live[rid]
                    done.append(rid)
        return done


def test_closed_loop_opens_in_steady_state():
    """The closed driver fills every slot in set-up with first requests
    whose outputs are cut to a share drawn from the seed, opens the
    window once each has its first token, then keeps every client's
    request in flight."""
    mod = bench._load(BENCH / "drivers" / "closed.py", "closed_driver")
    t = dict(_mix("tiny-closed"), clients=12,
             output={"dist": "uniform", "min": 20, "max": 40})
    loop = _Loop(slots=4)
    mod.drive(loop, t, 1000, 2**31 + 9)
    pool = traffic_lib.requests(t, 1000, 2**31 + 9)
    first = [loop.tracks[r] for r in range(4)]
    assert all(tr.max_new <= pool[c].max_new for c, tr in enumerate(first))
    assert len({tr.max_new for tr in first}) > 1
    assert loop.first_token_at_open and all(
        loop.first_token_at_open.values())
    # the other clients' first requests came when the window opened
    assert all(tr.submitted >= loop.opened_at
               for tr in list(loop.tracks.values())[4:])
    late = [tr for tr in loop.tracks.values() if tr.submitted > loop.t - 50]
    assert late and len(loop.live) + len(loop.queue) == 12


def test_a_planted_stall_moves_each_metric():
    """A stall moves the tail; a step that runs slower from some point
    on (a stall at every tick) moves the median as well."""
    base, stalled = _window(), _window(stall_at=0.5, stall=0.6)
    assert _read("itl_p95_ms", stalled) > _read("itl_p95_ms", base)
    for rid, tr in base.tracks.items():
        slowed = np.array(tr.stamps)
        slowed = np.where(slowed > tr.due + 0.1,
                          slowed + 0.5 * (slowed - tr.due - 0.1), slowed)
        tr.stamps = [float(x) for x in slowed]
    assert _read("itl_p50_ms", base) > 50.0 * 1.2
