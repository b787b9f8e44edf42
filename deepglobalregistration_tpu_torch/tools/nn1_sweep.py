"""Variant sweep of the two 1-NN kernels on the card.

    python -m deepglobalregistration_tpu_torch.tools.nn1_sweep

Each variant is a copy of ``csrc/nn1_scan.cu`` or ``csrc/nn1_mma.cu`` with
some constants substituted (queries a thread, unroll factors, warps, tile
sizes, launch bounds), built with the port's own ``nvcc`` flags into
``_build/variants/`` and launched through the usual wrappers (its library
takes the source's place in ``cuda_build``'s cache). At the four main-path
shapes (bench 14420 x 15265 and KITTI 38758 x 38664, at C = 3 and C = 32,
random rows: xyz-like at C = 3, unit-norm at C = 32) it prints, per variant,
the CUDA-graph time of one call in turns (variants forward, then backward)
and its index mismatches and max |d2 - plain| against the plain version.
Needs the card; prints ptxas's registers and spills of each variant.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from ..ops import knn
from ..utils import cuda_build
from .gather_bench import time_ms

OUT = cuda_build.BUILD / "variants"
VARIANTS = {
    "nn1_scan": {
        "base": [],
        "unroll4": [("#pragma unroll 8\n    for (int jj", "#pragma unroll 4\n    for (int jj")],
        "q4": [("kQ = 8;", "kQ = 4;")],
        "q12": [("kQ = 8;", "kQ = 12;"), ("(kThreads, 4)", "(kThreads, 3)")],
        "threads256": [("kThreads = 128;", "kThreads = 256;"),
                       ("(kThreads, 4)", "(kThreads, 2)")],
    },
    "nn1_mma": {
        "base": [],
        "unroll2": [("#pragma unroll 1\n    for (int sub", "#pragma unroll 2\n    for (int sub")],
        "mt1": [("return KS <= 4 ? 2 : 1;", "return 1;"), ("(kThreads, 2)", "(kThreads, 3)")],
        "small_split": [
            ("small[4] = {};", "small[4] = {}, small2[4] = {};"),
            ("mma(small, ah[mt][ks], bl", "mma(small2, ah[mt][ks], bl"),
            ("__fadd_rn(sum, small[e])", "__fadd_rn(sum, __fadd_rn(small[e], small2[e]))")],
        "warps4": [("kWarps = 8;", "kWarps = 4;"), ("(kThreads, 2)", "(kThreads, 4)")],
        "tile128": [("kTileN = 64;", "kTileN = 128;")],
    },
}
SHAPES = {"nn1_scan": [(14420, 15265, 3), (38758, 38664, 3)],
          "nn1_mma": [(14420, 15265, 32), (38758, 38664, 32)]}


def build_all() -> None:
    """One nvcc per variant, all started together."""
    procs = []
    for src, variants in VARIANTS.items():
        for name, subs in variants.items():
            d = OUT / f"{src}_{name}"
            d.mkdir(parents=True, exist_ok=True)
            for header in cuda_build.CSRC.glob("*.cuh"):
                shutil.copy(header, d)
            text = (cuda_build.CSRC / f"{src}.cu").read_text()
            for old, new in subs:
                if old not in text:
                    raise ValueError(f"{src} {name}: {old!r} not in the source")
                text = text.replace(old, new)
            (d / f"{src}.cu").write_text(text)
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v",
                   "-o", str(d / "lib.so"), str(d / f"{src}.cu")]
            procs.append((src, name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src} {name}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()]
        usage = [ln.split(":", 1)[1].strip() for ln in lines if "registers" in ln]
        spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes")]
        print(json.dumps({"variant": f"{src} {name}", "ptxas": usage,
                          "spills": spills}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA device")
    build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for src, shapes in SHAPES.items():
        kernel = getattr(knn, src)
        for n0, n1, c in shapes:
            F0 = torch.randn(n0, c, device="cuda", generator=g)
            F1 = torch.randn(n1, c, device="cuda", generator=g)
            if c > knn.SCAN_MAX_C:
                F0, F1 = (F / F.norm(dim=1, keepdim=True) for F in (F0, F1))
            else:
                F0, F1 = F0 * 20, F1 * 20  # LiDAR-like ranges
            i_p, d_p = knn.find_nn_plain(F0, F1, n0, n1)
            rows = {}
            names = list(VARIANTS[src])
            for name in names + names[::-1]:
                cuda_build._loaded[src] = ctypes.CDLL(str(OUT / f"{src}_{name}" / "lib.so"))
                i_k, d_k = kernel(F0, F1, n0, n1)
                torch.cuda.synchronize()
                ms = time_ms(lambda: kernel(F0, F1, n0, n1), calls=20, replays=5)
                rows.setdefault(name, []).append(
                    {"ms": ms, "index_mismatches": int((i_k != i_p).sum()),
                     "max_abs_d2_err": float((d_k - d_p).abs().max())})
            print(json.dumps({"kernel": src, "shape": f"{n0}x{n1} C={c}",
                              "device": torch.cuda.get_device_name(0),
                              "variants": rows}), flush=True)
    cuda_build._loaded.clear()


if __name__ == "__main__":
    main()
