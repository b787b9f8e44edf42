"""Wall-clock timers and meters (a copy of the JAX package's ``utils/timer.py``).

``Timer`` times the pipeline's stages (``DeepGlobalRegistration.stage_timers``),
the train step's (``make_train_step(timers=)``) and the evaluation loops'
``register`` calls. ``tic``/``toc`` read the host clock: ``register()``
returns a numpy array, which waits for the card. A stage on the card is
timed by ``utils/spans.span(..., cuda=True)`` instead: it hands the timer a
pair of CUDA events (``add_events``), which the timer reads only when it is
read, so timing a stage never stops the card.
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
    """tic/toc stopwatch with call averaging. A call may also be a pair of
    CUDA events still pending on the card (``add_events``): reading
    ``total_time``, ``avg`` or ``diff`` waits for the pending pairs' ends and
    adds their elapsed times, in the order they came; ``calls`` counts them
    without waiting; ``reset`` drops them."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._calls = 0
        self._diff = 0.0
        self._pending: list = []
        self.start_time = 0.0

    def _resolve(self) -> None:
        pending, self._pending = self._pending, []
        for start, end in pending:
            end.synchronize()
            self.add(start.elapsed_time(end) / 1000.0)

    @property
    def total_time(self) -> float:
        self._resolve()
        return self._total

    @property
    def diff(self) -> float:
        self._resolve()
        return self._diff

    @property
    def avg(self) -> float:
        self._resolve()
        return self._total / self._calls if self._calls else 0.0

    @property
    def calls(self) -> int:
        return self._calls + len(self._pending)

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.add(time.perf_counter() - self.start_time)
        return self.avg if average else self.diff

    def add(self, seconds: float) -> None:
        """Count one call of ``seconds`` timed elsewhere."""
        self._diff = seconds
        self._total += seconds
        self._calls += 1

    def add_events(self, start, end) -> None:
        """Count one call timed on the card, from CUDA event ``start`` to
        ``end`` (both recorded, perhaps not yet reached)."""
        self._pending.append((start, end))
