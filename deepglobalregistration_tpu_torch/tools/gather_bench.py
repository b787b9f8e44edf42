"""Gather probe: int32 lookups into an occupancy-bit table, three ways.

Counterpart of the JAX package's ``tools/pallas_gather_bench.py``, with the
same ``WORDS``-word table (256^3 occupancy bits, 2 MiB) and ``N = 27 *
16384`` indices drawn from numpy's ``default_rng(0)``. A second named shape,
``kitti``, is the same probe at the KITTI-scale configuration
(``tools/kitti_scale_smoke.py:59-60``): ``dense_extent`` 384x384x48 is
``KITTI_WORDS = 221184`` words (0.84 MiB, 1728 rows of 128) and the 65536
voxel bucket gives ``KITTI_N = 27 * 65536`` indices. It times ``table[idx]``
(the counterpart of the probe's ``xla_gather``), the flat kernel
``ops.gather.take`` and the row-then-lane kernel ``ops.gather.take2d``, and
checks both kernels against ``table[idx]`` (``exact=``).

    python -m deepglobalregistration_tpu_torch.tools.gather_bench [--shape kitti] [--device cpu]

On the card each time is the mean of one call over CUDA-graph replays
between CUDA events, so the host's launch time is not in it; on the CPU
(``--device cpu``, the plain versions) it is the host clock.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import gather
from ..utils import device as device_utils

WORDS = 512 * 1024  # 2 MiB int32 table
N = 27 * 16384      # indices per probe
KITTI_WORDS = 384 * 384 * 48 // 32
KITTI_N = 27 * 65536
SHAPES = {"bench": (WORDS, N), "kitti": (KITTI_WORDS, KITTI_N)}


def make_inputs(words: int = WORDS, n: int = N, seed: int = 0,
                device: str | torch.device = "cuda"):
    """The probe's table [words] and indices [n] in [0, words), int32."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 30, words, dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, words, n, dtype=np.int64).astype(np.int32)
    return (torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device))


def time_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Mean ms of one ``fn()`` on the card: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def host_ms(fn, calls: int = 20) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def run(device: str | torch.device = "cuda", words: int = WORDS, n: int = N,
        seed: int = 0) -> dict:
    """The probe: times and exactness of the three gathers on one device."""
    dev = device_utils.resolve_device(device)
    table, idx = make_inputs(words, n, seed, dev)
    table2d = table.view(words // gather.LANES, gather.LANES)
    ref = table[idx]
    clock = time_ms if dev.type == "cuda" else host_ms
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "clock": "cuda graph + events" if dev.type == "cuda" else "host",
           "words": words, "n": n,
           "table_index_ms": clock(lambda: table[idx])}
    for name, fn, tab in (("take", gather.take, table),
                          ("take2d", gather.take2d, table2d)):
        got = fn(tab, idx)
        out[f"{name}_exact"] = bool(torch.equal(got, ref))
        out[f"{name}_ms"] = clock(lambda: fn(tab, idx))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="bench")
    args = ap.parse_args(argv)
    words, n = SHAPES[args.shape]
    r = run(args.device, words=words, n=n)
    for name in ("table_index", "take", "take2d"):
        ms = r[f"{name}_ms"]
        exact = f"  exact={r[f'{name}_exact']}" if name != "table_index" else ""
        print(f"{name}: {ms:.6f} ms  ({r['n'] / ms / 1e3:.0f} M elem/s){exact}")
    print(json.dumps(r))
    return 0 if r["take_exact"] and r["take2d_exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
