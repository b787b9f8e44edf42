"""Export a small feature-only (FCGF) checkpoint for the benchmark.

Counterpart of the repo's ``tools/export_bench_weights.py``. The reference
benchmarks with trained weights (README.md:41-67 downloads a pretrained
.pth before scripts/test_3dmatch.py). This tool takes just the FCGF tree
of a checkpoint of the synthetic chain (``tools/synthetic_e2e.py`` stage
A), stores it bf16 and deflated (a few MB, unlike the ~400 MB 6D inlier
tree), and stamps the network config that ``DeepGlobalRegistration`` needs
to rebuild the model. Both packages' ``load_checkpoint`` read the result.

Usage: python -m deepglobalregistration_tpu_torch.tools.export_bench_weights \\
           --ckpt outputs/synthetic_e2e/fcgf_selftrained.pkl --out bench_fcgf.pkl

``--out`` defaults to the committed ``weights/fcgf_synthetic.pkl``, as the
repo's tool does; pass another path unless that file is to be replaced.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..utils import checkpoint as ckpt_utils


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="weights/fcgf_synthetic.pkl")
    ap.add_argument("--feat_model", default="ResUNetBN2C")
    ap.add_argument("--feat_model_n_out", type=int, default=32)
    ap.add_argument("--feat_conv1_kernel_size", type=int, default=7)
    ap.add_argument("--voxel_size", type=float, default=0.05)
    ap.add_argument("--inlier_model", default="ResUNetBN2C")
    ap.add_argument("--inlier_conv1_kernel_size", type=int, default=3)
    args = ap.parse_args(argv)

    state = ckpt_utils.load_checkpoint(args.ckpt)
    sd = state["state_dict"]
    config = {
        "voxel_size": args.voxel_size,
        "inlier_feature_type": "ones",
        "feat_model": args.feat_model,
        "feat_model_n_out": args.feat_model_n_out,
        "feat_conv1_kernel_size": args.feat_conv1_kernel_size,
        "inlier_model": args.inlier_model,
        "inlier_conv1_kernel_size": args.inlier_conv1_kernel_size,
        "bn_momentum": 0.05,
        "normalize_feature": True,
    }
    ckpt_utils.save_checkpoint(
        args.out, epoch=state.get("epoch", 0), params=sd["params"],
        state=sd["state"], config=config, dtype="bf16", compress=True)
    print(f"wrote {args.out}: {Path(args.out).stat().st_size / 1e6:.1f} MB")
    return args.out


if __name__ == "__main__":
    main()
