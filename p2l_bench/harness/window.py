"""The measured window over a search driver's own loop.

A driver (``BasinCMAOptimizer.optimize``, ``CMAOptimizer.optimize``) asks
its strategy for a population at the start of every generation, and once
more for its final population (``_StrategyDriver._ask_population``). The
window wraps that call on the optimizer the harness built: every call after
the first marks the end of a generation, and the driver has already read
the generation's tell loss there, so the card has finished it and the
wrapper adds no wait of its own. The first generation is the warm-up; the
window opens where the second starts. At the first generation end at or
after ``seconds``, the window closes; a generation still running at the
window's end counts neither its work nor its time. When an inversion's
generations are all done, its final ask stops that inversion (its final
Adam steps are not measured) and the harness starts the next one.

Where the window closes (``on_close``), the driver goes on with one more
generation, outside the counted time, for the comparison to judge; the
run stops at its end (``StopWindow``). With ``seconds`` 0 the window
closes as it opens, so that the generation after the warm-up is the judged
one.

On several ranks the decision to stop is rank 0's, shared by one 4-byte
all-reduce at every generation end, so that every rank stops at the same
generation.
"""

from __future__ import annotations

import time


class StopWindow(Exception):
    """The window is over."""


class EndOfInversion(Exception):
    """An inversion's generations are done; its final ask is not run."""


class Window:

    def __init__(self, opt, meta_steps: int, seconds: float,
                 on_open=None, on_generation=None, share=None,
                 on_close=None):
        self.opt = opt
        self.meta_steps = int(meta_steps)
        self.seconds = float(seconds)
        self.on_open = on_open
        self.on_generation = on_generation
        self.on_close = on_close
        self.share = share
        self.asks = 0
        self.running = False
        self.closed = False
        self.t_open = None
        self.starts, self.ends = [], []
        self._orig = opt._ask_population

    def install(self):
        self.opt._ask_population = self._ask

    def remove(self):
        if self.opt.__dict__.get("_ask_population") == self._ask:
            del self.opt._ask_population

    def new_inversion(self):
        self.asks = 0

    def _ask(self, *args, **kwargs):
        now = time.perf_counter()
        if self.running:
            self.running = False
            if self.closed:
                # the generation after the window is done
                raise StopWindow()
            self._generation_end(now)
        self.asks += 1
        if self.asks > self.meta_steps:
            raise EndOfInversion()
        result = self._orig(*args, **kwargs)
        self.running = True
        if self.t_open is not None:
            self.starts.append(time.perf_counter())
        return result

    def _generation_end(self, now):
        if self.t_open is None:
            # the warm-up generation is done: the window opens
            if self.on_open is not None:
                self.on_open()
            self.t_open = time.perf_counter()
            if self.seconds <= 0:
                self._close()
            return
        self.ends.append(now)
        if self.on_generation is not None:
            self.on_generation(len(self.ends))
        stop = now - self.t_open >= self.seconds
        if self.share is not None:
            stop = self.share(stop)
        if stop:
            self._close()

    def _close(self):
        self.closed = True
        if self.on_close is not None:
            self.on_close()

    def counted(self):
        """``(generations, seconds)``: the generations that ended inside
        the window and the time from its opening to the last of their
        ends."""
        t_end = self.t_open + self.seconds
        ends = [e for e in self.ends if e <= t_end]
        if not ends:
            return 0, 0.0
        return len(ends), ends[-1] - self.t_open

    def generation_seconds(self):
        """Each counted generation's own wall time, from the return of its
        ask to its end (harness work at a boundary left out)."""
        n, _ = self.counted()
        return [e - s for s, e in zip(self.starts[:n], self.ends[:n])]
