"""Driver: the training step of ``train_step``, with the conv's tile counts.

The same set-up, window and check as ``train_step``. Before the first
traced call it zeroes the program's tile counters (``ops/sparse_conv.py``'s
``tile_counts``: by pass, the tile rows each conv launched and the edges
among them), keeps apart what the frozen FCGF's forward adds to them, and
hands the inlier net's counts to the readers through ``traced_work()``
(``tiles``: pass -> (tile rows, edges)). A program without the counters
gives ``tiles`` None, and the metrics that read them are left out.
"""

from __future__ import annotations

from typing import Dict

from . import train_step


def _counters():
    """The program's counters by pass, or None where it has none."""
    from deepglobalregistration_tpu_torch.ops import sparse_conv
    return getattr(sparse_conv, "tile_counts", None)


def _read(counts) -> Dict[str, tuple]:
    return {p: (int(c.tile_rows), int(c.edges)) for p, c in counts.items()}


class Driver(train_step.Driver):
    fcgf_tiles = None  # FCGF's share of the counts, pass -> (rows, edges), once traced

    def call(self, traced: bool = False) -> int:
        counts = _counters() if traced else None
        if counts is None:
            return super().call(traced)
        if self.fcgf_tiles is None:  # the first traced call
            for c in counts.values():
                c.reset()
            self.fcgf_tiles = {p: (0, 0) for p in counts}
        ts, orig = self.ts, self.ts.fcgf_features

        def fcgf_features(fcgf, batch):  # the frozen 3D net's convs, kept apart
            before = _read(counts)
            try:
                return orig(fcgf, batch)
            finally:
                for p, (rows, edges) in _read(counts).items():
                    r, e = self.fcgf_tiles[p]
                    self.fcgf_tiles[p] = (r + rows - before[p][0], e + edges - before[p][1])

        ts.fcgf_features = fcgf_features
        try:
            return super().call(traced)
        finally:
            ts.fcgf_features = orig

    def traced_work(self) -> Dict:
        out = super().traced_work()
        out["tiles"] = None
        if self.fcgf_tiles is not None:
            own = self.fcgf_tiles
            out["tiles"] = {p: (rows - own[p][0], edges - own[p][1])
                            for p, (rows, edges) in _read(_counters()).items()}
        return out
