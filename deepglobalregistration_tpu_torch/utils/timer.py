"""Wall-clock timers and meters (a copy of the JAX package's ``utils/timer.py``).

``Timer`` times the pipeline's stages (``DeepGlobalRegistration.stage_timers``)
and the evaluation loops' ``register`` calls. It reads the host clock, so a
caller timing work on the card synchronises before ``toc``: the pipeline's
stages do, and ``register()`` returns a numpy array, which waits for the card.
"""

from __future__ import annotations

import time


class AverageMeter:
    """Running average of a scalar series."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2


class Timer:
    """tic/toc stopwatch with call averaging."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.add(time.perf_counter() - self.start_time)
        return self.avg if average else self.diff

    def add(self, seconds: float) -> None:
        """Count one call of ``seconds`` timed elsewhere."""
        self.diff = seconds
        self.total_time += seconds
        self.calls += 1
        self.avg = self.total_time / self.calls
