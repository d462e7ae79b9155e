"""The window over a driver's loop: a generation cut by the window's end
counts neither its work nor its time, inversions follow one another, the
final population is never asked, and the rate is work over time."""

import pytest

from p2l_bench import run as run_cli
from p2l_bench.harness import window as W


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Driver:
    """A driver that asks once a generation, ``meta`` generations, then
    asks its final population; each generation takes ``gen_s``."""

    def __init__(self, clock, gen_s, meta):
        self.clock, self.gen_s, self.meta = clock, list(gen_s), meta
        self.asked = 0
        self.losses = []

    def _ask_population(self):
        self.asked += 1

    def optimize(self):
        for _ in range(self.meta):
            self._ask_population()
            self.clock.t += self.gen_s.pop(0)
            self.losses.append(1.0)
        self._ask_population()
        raise AssertionError("the final population was asked")


def drive(monkeypatch, gen_s, meta, seconds):
    clock = Clock()
    monkeypatch.setattr(W.time, "perf_counter", clock)
    drv = Driver(clock, gen_s, meta)
    opened = []
    win = W.Window(drv, meta, seconds,
                   on_open=lambda: opened.append(clock.t),
                   on_close=lambda: opened.append(("closed", clock.t)))
    win.install()
    inversions = 0
    with pytest.raises(W.StopWindow):
        while True:
            win.new_inversion()
            inversions += 1
            try:
                drv.optimize()
            except W.EndOfInversion:
                continue
    return win, opened, inversions


def test_cut_generation_counts_neither_work_nor_time(monkeypatch):
    # warm-up 9 s, then generations of 7, 7, 7, 8: the window of 20 s
    # opens at 109 and closes at 129; the third ends at 130, past it
    win, opened, _ = drive(monkeypatch, [9, 7, 7, 7, 8], 30, 20)
    assert opened == [109.0, ("closed", 130.0)]
    gens, secs = win.counted()
    assert (gens, secs) == (2, 14.0)
    assert win.generation_seconds() == [7.0, 7.0]
    wl = {"rate_metric": "images_per_s", "work_per_row": 30, "checks": {}}
    out = {"generations": gens, "window_s": secs, "setup_s": 5.0,
           "failed": 0, "peak_bytes": 1, "readings": {}}
    line = run_cli.result_line(wl, {"popsize": 18}, {
        "end_to_end": [{"name": "images_per_s", "unit": "images/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}, out, False, {"name": "card"}, 1)
    assert line["metrics"]["images_per_s"]["value"] == pytest.approx(
        2 * 18 * 30 / 14.0)
    assert line["attempted"] == 2 and line["correct"]


def test_inversions_follow_one_another(monkeypatch):
    # 3 generations an inversion: warm-up and two in the first, then the
    # next inversion's; its final ask is never run; the window closes at
    # that inversion's end, and the judged generation opens a third
    win, _, inversions = drive(monkeypatch, [1, 1, 1, 1, 1, 1, 1], 3, 4.5)
    assert inversions == 3
    assert win.counted() == (4, 4.0)


def test_exact_window_end_counts(monkeypatch):
    win, _, _ = drive(monkeypatch, [1, 2, 2, 2], 30, 4)
    assert win.counted() == (2, 4.0)


def test_one_generation_runs_after_the_window(monkeypatch):
    # the window closes at 105 (4 s); the driver runs one more generation
    # (2 s), uncounted, and stops where it ends
    win, opened, _ = drive(monkeypatch, [1, 2, 2, 2, 3], 30, 4)
    assert opened == [101.0, ("closed", 105.0)]
    assert win.counted() == (2, 4.0)
    # asked: the warm-up, two counted generations and the judged one
    assert win.opt.asked == 4 and win.opt.gen_s == [3]


def test_no_window_judges_the_generation_after_the_warm_up(monkeypatch):
    win, opened, _ = drive(monkeypatch, [1, 2, 2], 30, 0)
    assert opened == [101.0, ("closed", 101.0)]
    assert win.counted() == (0, 0.0)
    assert win.opt.gen_s == [2]
