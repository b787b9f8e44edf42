"""Variant sweep of the gather probe's two kernels on the card.

    python -m deepglobalregistration_tpu_torch.tools.gather_sweep [--turns 4]

At the probe shapes of ``tools/gather_bench.py`` (bench: W = 524288 words,
N = 442368; KITTI: W = 221184, N = 1769472) and, as a diagnostic, at tables
of 16384 to 131072 words (64 to 512 KiB, from what every SM's L1 holds to
what it does not; the KITTI N), for both forms (``take``, ``take2d``), it
times in turns (variants forward, then backward, repeated):

- ``shipped``: ``csrc/gather.cu`` through ``ops/gather.py`` (one index a
  thread, a block for every 256 indices), which is also the first design;
- ``A v{V} t{T}``: design A of ``tools/gather_variants.cu`` at V = 2, 4, 8
  indices a thread and T = 128, 256 threads a block, one wave of blocks;
  ``A v{V} l1max`` / ``l1min`` with the kernel's shared-memory carveout at
  0 % / 100 % (the most / the least L1 for the table's lines; V = 1 is the
  shipped body); ``A v{V} cached``: index loads that allocate in L1 and
  plain stores;
- ``B k{K}``: the table in a cluster's distributed shared memory, at the
  cluster sizes whose slice fits a block's 227 KB;
- ``table[idx]``, PyTorch's own gather, as the yardstick.

Each time is the CUDA-graph ms of one call (``gather_bench.time_ms``); the
same variant at N = 1 under the same clock is its fixed cost, and N over
the difference its lookups a second. Every variant is held bit for bit
against ``table[idx]`` at N, N - 1 and on the 4-byte misaligned view
``idx[1:]``. ptxas's registers and spills of every kernel are printed
first. Needs the card; one JSON line a shape and form, and exit code 1 if
any variant was not exact.

``geometry`` lays out a design-A launch in plain Python, so that the CPU
tests reach it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from ..ops import gather
from ..utils import cuda_build
from . import gather_bench as gb

SOURCE = Path(__file__).with_name("gather_variants.cu")
LIB = cuda_build.BUILD / "variants" / "libgather_variants.so"
SHAPES = {**gb.SHAPES,
          **{f"w{w}": (w, gb.KITTI_N) for w in (16384, 32768, 65536, 131072)}}
VS = (1, 2, 4, 8)  # the widths tools/gather_variants.cu instantiates
THREADS = 256
CLUSTER_THREADS = 1024
SMEM_BLOCK = 232448  # bytes of shared memory a block may use
SECTOR = 32          # bytes an L2 sector
# Design A's variants: name -> (V, threads, cached, carveout).
A_VARIANTS = {
    **{f"A v{v} t{t}": (v, t, False, -1) for v in (2, 4, 8) for t in (128, 256)},
    **{f"A v{v} l1max": (v, 256, False, 0) for v in (1, 4)},
    **{f"A v{v} l1min": (v, 256, False, 100) for v in (1, 4)},
    **{f"A v{v} cached": (v, 256, True, -1) for v in (4, 8)},
}


class Geometry(NamedTuple):
    v: int        # indices a thread a loop step
    words: int    # words a piece: 4 (16 bytes), or v for v < 4
    threads: int  # threads a block
    blocks: int   # blocks: one wave at most for v > 1
    head: int     # scalar elements before idx and out reach 16-byte alignment
    pieces: int   # vector pieces after the head
    tail: int     # scalar elements after the pieces


def geometry(n: int, offset: int, resident_blocks: int, v: int,
             threads: int = THREADS) -> Geometry:
    """Design A's launch for ``n`` indices whose first lies ``offset`` bytes
    past a 16-byte boundary (``out`` is allocated at the same offset).
    V = 1: thread i takes index i, a block for every ``threads`` indices.
    V > 1: ``resident_blocks`` is how many blocks of ``threads`` fit on the
    card at once; the grid never exceeds one wave, and a grid-stride loop
    takes the rest."""
    if v not in VS:
        raise ValueError(f"v must be one of {VS}, got {v}")
    if offset % 4:
        raise ValueError(f"an int32 tensor lies at a multiple of 4 bytes, got {offset}")
    if v == 1:
        return Geometry(1, 1, threads, max(1, -(-n // threads)), 0, n, 0)
    words = min(v, 4)
    head = min(n, (-offset % 16) // 4)
    pieces = (n - head) // words
    tail = n - head - pieces * words
    per_block = threads * (v // words)  # pieces a block takes a loop step
    blocks = max(1, min(-(-pieces // per_block), resident_blocks))
    return Geometry(v, words, threads, blocks, head, pieces, tail)


def aligned_like(idx: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor shaped like ``idx`` that lies at the same
    offset from a 16-byte boundary, so the vector pieces of ``idx`` and of
    the output line up."""
    buf = torch.empty(idx.numel() + 3, dtype=torch.int32, device=idx.device)
    shift = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[shift:shift + idx.numel()]


def build() -> ctypes.CDLL:
    """Build the variants and the shipped source, one nvcc each, at once;
    print ptxas's registers and spills of every kernel; load the variants."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, out in ((SOURCE, LIB), (cuda_build.CSRC / "gather.cu",
                                     LIB.with_name("libgather_ptxas.so"))):
        procs[src.name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v", "-o",
             str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ("registers" in line or "spill" in line):
                print(json.dumps({"source": name, "ptxas": entry,
                                  "line": line.split(":", 1)[-1].strip()}), flush=True)
    lib = ctypes.CDLL(str(LIB))
    lib.dgr_take_a_resident_blocks.argtypes = [ctypes.c_int] * 4
    lib.dgr_take_a_resident_blocks.restype = ctypes.c_int
    lib.dgr_take_a.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               *[ctypes.c_int] * 7, ctypes.c_void_p]
    lib.dgr_take_a.restype = ctypes.c_int
    lib.dgr_take_cluster_blocks.argtypes = [ctypes.c_int] * 4
    lib.dgr_take_cluster_blocks.restype = ctypes.c_int
    lib.dgr_take_cluster.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, *[ctypes.c_int] * 5, ctypes.c_void_p]
    lib.dgr_take_cluster.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def design_a(lib, two_d: bool, v: int, threads: int, cached: bool,
             carveout: int):
    """A launch of design A, and its grid's blocks at the probe's N."""
    resident = 0
    if v > 1:
        resident = lib.dgr_take_a_resident_blocks(int(two_d), v, int(cached), threads)
        if resident <= 0:
            raise RuntimeError(f"no resident blocks for design A (v={v}, threads={threads})")

    def call(tab, idx):
        out = aligned_like(idx)
        g = geometry(idx.numel(), idx.data_ptr() % 16, resident, v, threads)
        _check(lib.dgr_take_a(int(two_d), int(cached), tab.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), idx.numel(), v, threads, g.blocks,
                              g.head, g.pieces, carveout,
                              torch.cuda.current_stream().cuda_stream),
               f"design A v={v}")
        return out
    return call, lambda n: geometry(n, 0, resident, v, threads).blocks


def cluster(lib, two_d: bool, k: int):
    def call(tab, idx):
        out = aligned_like(idx)
        g = geometry(idx.numel(), idx.data_ptr() % 16, 1, v=4)
        _check(lib.dgr_take_cluster(int(two_d), tab.data_ptr(), tab.numel(),
                                    idx.data_ptr(), out.data_ptr(), idx.numel(),
                                    k, CLUSTER_THREADS, g.head, g.pieces,
                                    torch.cuda.current_stream().cuda_stream),
               f"cluster k={k}")
        return out
    return call


def variants(lib, words: int, n: int, two_d: bool) -> dict:
    """name -> (call(table, idx), blocks in its grid at the probe's N)."""
    out = {"shipped": (gather.take2d_cuda if two_d else gather.take_cuda, -(-n // 256))}
    for name, (v, t, cached, carveout) in A_VARIANTS.items():
        call, blocks = design_a(lib, two_d, v, t, cached, carveout)
        out[name] = (call, blocks(n))
    for k in (2, 4, 8, 16):
        slice_bytes = -(-words // k // gather.LANES) * gather.LANES * 4
        if slice_bytes + 64 > SMEM_BLOCK:
            continue
        blocks = lib.dgr_take_cluster_blocks(int(two_d), words, k, CLUSTER_THREADS)
        if blocks <= 0:
            print(json.dumps({"variant": f"B k{k}", "words": words,
                              "unavailable": f"CUDA error {-blocks}"}), flush=True)
            continue
        out[f"B k{k}"] = (cluster(lib, two_d, k), blocks)
    out["table[idx]"] = (lambda tab, idx: tab.view(-1)[idx], None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4,
                    help="passes over the variants, alternately forward and backward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA device")
    lib = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    ok = True
    for shape, (words, n) in SHAPES.items():
        table, idx = gb.make_inputs(words, n, device="cuda")
        ref = table[idx]
        for two_d in (False, True):
            tab = table.view(-1, gather.LANES) if two_d else table
            vs = variants(lib, words, n, two_d)
            rows = {}
            for name, (call, blocks) in vs.items():
                exact = all(torch.equal(call(tab, idx[a:b]), ref[a:b])
                            for a, b in ((0, n), (0, n - 1), (1, n)))
                ok &= exact
                rows[name] = {"exact": exact, "ms": [], "ms_n1": []}
                if blocks is not None:
                    rows[name]["blocks"] = blocks
            names = list(vs)
            for turn in range(args.turns):
                for name in names if turn % 2 == 0 else names[::-1]:
                    call = vs[name][0]
                    rows[name]["ms"].append(gb.time_ms(lambda: call(tab, idx)))
                    rows[name]["ms_n1"].append(gb.time_ms(lambda: call(tab, idx[:1])))
            for r in rows.values():  # lookups a second beyond the fixed cost
                extra = statistics.median(r["ms"]) - statistics.median(r["ms_n1"])
                r["lookups_per_s_beyond_n1"] = n / extra * 1e3 if extra > 0 else None
            print(json.dumps({
                "shape": shape, "form": "take2d" if two_d else "take",
                "words": words, "n": n, "card": card,
                "bound_ms": (8 * n + 4 * words) / 3.35e12 * 1e3,
                "l2_sector_bytes": n * SECTOR, "stream_bytes": 8 * n,
                "variants": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
