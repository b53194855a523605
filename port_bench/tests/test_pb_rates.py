"""The window's arithmetic on a fake clock: every rate is all the window's
whole steps over the time from a synchronised start to the synchronise after
the last one, and the tail is the tail of every call."""

import statistics

import pytest

from harness import readers
from harness.window import closed_loop, p95, timed_calls, warm_up


class Clock:
    """A clock that only the fake card and the fake steps move."""

    def __init__(self):
        self.t = 100.0
        self.syncs = []

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_closed_loop_counts_whole_steps_to_the_last_synchronise():
    clock = Clock()
    step = lambda: clock.advance(0.3)  # enqueue time of a step

    def sync():  # the card finishes what was queued
        clock.syncs.append(clock.t)
        clock.advance(0.05)

    got = closed_loop(step, 1.0, sync, clock)
    # start after the first synchronise; steps at 0.3, 0.6, 0.9, 1.2 (the last starts at 0.9 < 1.0)
    assert got["steps"] == 4
    assert got["seconds"] == pytest.approx(4 * 0.3 + 0.05)
    run = {"window": got, "batch": 64, "frames": 500, "counts": {"model": 2e12}}
    assert readers.frames_per_s(run) == pytest.approx(4 * 64 * 500 / 1.25)
    assert readers.mfu(run) == pytest.approx(100 * 2e12 * 4 / 1.25 / 67e12)


def test_timed_calls_times_every_call_and_the_window():
    clock = Clock()
    lengths = iter([0.002, 0.003, 0.010, 0.004] * 100)
    fetched = []
    call = lambda: clock.advance(next(lengths)) or "out"
    got = timed_calls(call, 0.05, lambda: clock.advance(0.001), lambda o: fetched.append(o), clock)
    assert len(got["latencies"]) == got["steps"] == len(fetched)
    assert all(v == pytest.approx(d + 0.001) for v, d in zip(got["latencies"], [0.002, 0.003, 0.010, 0.004] * 100))
    assert got["seconds"] == pytest.approx(sum(got["latencies"]))
    run = {"window": got, "batch": 64}
    assert readers.samples_per_s(run) == pytest.approx(64 * got["steps"] / got["seconds"])
    assert readers.p95_ms(run) == pytest.approx(1e3 * statistics.quantiles(got["latencies"], n=100)[94])


def test_p95_is_the_tail_of_every_latency():
    lat = [float(i) for i in range(1, 201)]
    assert p95(lat) == statistics.quantiles(lat, n=100)[94]
    assert p95([1.0]) is None


def test_warm_up_runs_a_fixed_count_then_synchronises():
    clock, calls = Clock(), []
    warm_up(lambda: calls.append("step") or clock.advance(0.5), lambda: calls.append("sync"), 3)
    assert calls == ["step", "step", "step", "sync"]


def test_readers_read_nothing_rather_than_zero():
    empty = {"window": {"steps": 0, "seconds": 0.0, "latencies": []}, "batch": 64, "frames": 500,
             "counts": {"model": 1.0, "conv": 1.0, "vq_calls": []},
             "trace": {"busy_s": 0.0, "window_s": 1.0, "steps": 1, "kernels": [], "host_ops": []}}
    for f in (readers.frames_per_s, readers.samples_per_s, readers.p95_ms, readers.mfu, readers.device_idle):
        assert f(empty) is None
    assert readers.conv_roofline(empty, ("aten::convolution",)) is None
    assert readers.vq_nearest_roofline(empty, "vq_nearest_kernel") is None
    assert readers.share_under(empty, ("bench.otf_batch",)) is None
