"""The reduction of a profiled window, on synthetic records."""
import numpy as np
import pytest

from harness import trace


class _Ev:
    def __init__(self, name, start, end, cuda, user=False):
        self._n, self._s, self._e = name, start, end
        self._cuda, self._user = cuda, user

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._user

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": res})()


def test_merge_is_the_union():
    iv = np.array([[5, 7], [0, 2], [1, 3], [6, 9], [10, 11]])
    assert trace._merge(iv).tolist() == [[0, 3], [5, 9], [10, 11]]


def test_reduce_busy_idle_and_spans():
    ev = [_Ev("pb.tick", 0, 100, False, True),
          _Ev("pb.replay", 10, 40, False, True),
          _Ev("pb.sample", 60, 70, False, True),
          _Ev("pb.tick", 120, 200, False, True),
          _Ev("gemm", 12, 30, True), _Ev("dsl_executor_kernel_x", 25, 38,
                                         True),
          _Ev("argmax", 62, 66, True), _Ev("gemm", 130, 190, True),
          _Ev("gemm", 250, 260, True),          # after the window
          _Ev("pb.tick", 5, 6, True, True)]     # a device-side annotation
    r = trace.reduce(_Prof(ev))
    assert r["window_s"] == pytest.approx(200e-9)
    assert r["busy_s"] == pytest.approx((38 - 12 + 4 + 60) * 1e-9)
    assert r["executor_records"] == 1
    assert r["executor_s"] == pytest.approx(13e-9)
    gaps = dict(r["idle_gaps"])
    # 0-12 in the tick, 38-62 (midpoint 50: tick), 66-130 (midpoint 98:
    # tick), 190-200 in the second tick
    assert gaps["tick"] == pytest.approx((12 + 24 + 64 + 10) * 1e-9)
    assert dict(r["device_ops"])["gemm"] == pytest.approx((18 + 60) * 1e-9)
