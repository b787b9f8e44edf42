"""Variant sweep of the slot-sum kernels on the card.

    python -m deepglobalregistration_tpu_torch.tools.slot_sum_sweep

Each variant is a copy of ``csrc/slot_sum.cu`` with some constants
substituted (the by-row kernel's values in flight a lane, block size and
launch bounds; the runs kernel's ring of stages, copy width and slab
widths), built with the port's own ``nvcc`` flags into
``_build/variants/`` and launched through the usual wrappers (its library
takes the source's place in ``cuda_build``'s cache). On the main path's
maps (``slot_sum_bench.slot_cases`` of bench pair 0, random values) it
prints, per case, each variant's CUDA-graph time in turns (variants
forward, then backward) and whether it equals the plain version bit for
bit. Needs the card; prints ptxas's registers and spills of each variant.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..utils import cuda_build
from .gather_bench import time_ms

OUT = cuda_build.BUILD / "variants"
_LONG = ("launch_runs<4, 2, 16, kLongSlab>", "launch_runs<1, 2, 16, kLongSlab>")
VARIANTS = {
    "base": [],
    # The by-row kernel: more values in flight a lane, bigger blocks.
    "batch8": [("kBatch = 4;", "kBatch = 8;"), ("(kThreads, 8)", "(kThreads, 6)")],
    "batch16_t256": [("kBatch = 4;", "kBatch = 16;"), ("kThreads = 128;", "kThreads = 256;"),
                     ("(kThreads, 8)", "(kThreads, 2)")],
    "t256": [("kThreads = 128;", "kThreads = 256;"), ("(kThreads, 8)", "(kThreads, 4)")],
    # The runs kernel: the ring's shape, the copy width, the slabs.
    "ring8x8": [(a, a.replace("2, 16", "8, 8")) for a in _LONG],
    "ring2x32": [(a, a.replace("2, 16", "2, 32")) for a in _LONG],
    "runs_scalar": [("if (vec4) return launch_runs<4", "if (false) return launch_runs<4")],
    "long256": [("kLongSlab = 128;", "kLongSlab = 256;")],
    "short512": [("kShortSlab = 128;", "kShortSlab = 512;")],
}


def build_all() -> None:
    """One nvcc per variant, all started together."""
    procs = []
    for name, subs in VARIANTS.items():
        d = OUT / f"slot_sum_{name}"
        d.mkdir(parents=True, exist_ok=True)
        text = (cuda_build.CSRC / "slot_sum.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise ValueError(f"slot_sum {name}: {old!r} not in the source")
            text = text.replace(old, new)
        (d / "slot_sum.cu").write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v",
               "-o", str(d / "lib.so"), str(d / "slot_sum.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for slot_sum {name}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()]
        usage = [ln.split(":", 1)[1].strip() for ln in lines if "registers" in ln]
        spills = [ln for ln in lines if "spill" in ln and not ln.startswith("0 bytes")]
        print(json.dumps({"variant": name, "ptxas": usage, "spills": spills}), flush=True)


def cases(g) -> list:
    """``slot_sum_bench.slot_cases`` on bench pair 0's plans."""
    import chip_smoke as cs

    from ..config import default_config
    from ..core.pipeline import DeepGlobalRegistration
    from ..utils.synthetic import synthetic_pair
    from .slot_sum_bench import slot_cases

    dgr = DeepGlobalRegistration(default_config(bf16=True, **cs.BENCH), device="cuda")
    return slot_cases(cs._pair_plans(dgr, synthetic_pair(n=30000, seed=0)), g)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA device")
    build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    names = list(VARIANTS)
    for c in cases(g):
        kernel, out0 = c["kernel"], c["out0"]
        want = c["plain"](out0.clone())
        rows = {}
        for name in names + names[::-1]:
            cuda_build._loaded["slot_sum"] = ctypes.CDLL(
                str(OUT / f"slot_sum_{name}" / "lib.so"))
            got = kernel(out0.clone())
            torch.cuda.synchronize()
            out = out0.clone()
            rows.setdefault(name, []).append(
                {"ms": time_ms(lambda: kernel(out), calls=20, replays=5),
                 "bit_for_bit": bool(torch.equal(got.view(torch.int32),
                                                 want.view(torch.int32)))})
        print(json.dumps({"case": c["case"], "device": torch.cuda.get_device_name(0),
                          "variants": rows}), flush=True)
    cuda_build._loaded.clear()


if __name__ == "__main__":
    main()
