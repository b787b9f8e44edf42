"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. build the CUDA kernels from ``deepglobalregistration_tpu_torch/csrc``
     (one nvcc per source, started together) and print the card's name and
     power limit;
  2. hold the two 1-NN kernels against the plain PyTorch version on the
     card, on random inputs at the bench's row counts (full, ragged, no
     candidate, exact duplicates): ``nn1_scan`` (C <= 8) at C = 3 and 8 to
     2 f32 ulps of the plain d2, ``nn1_mma`` (3xTF32, 8 < C <= 64) at C = 9,
     32 and 64 to 2^-20 of |a|^2 + |b|^2 against the exact f64 d2; index
     mismatches only on near-ties, none on exact duplicates;
  3. the gather probe (``tools/gather_bench.py``, the counterpart of the JAX
     package's ``tools/pallas_gather_bench.py``) at its bench shape and the
     KITTI scale's, with its launch counts set to 0 just before each and
     read just after; then both gather kernels against their plain versions
     at each shape, at ragged index counts and on the view 4 bytes past the
     indices' start (exact equality), and the plain versions' times;
  4. drive ``DeepGlobalRegistration.register()`` at the bench configuration
     (ResUNetBN2C FCGF conv1=7 / 32-dim, bf16 convs, 5 cm voxel, dense
     extent 256^3, random-init 6D inlier net, committed FCGF weights) on a
     warm-up pair and the four ``synthetic_pair(n=30000, seed=0..3)`` pairs,
     with the launch counts set to 0 just before and read just after;
     check pose accuracy against ground truth and that the kernels were
     launched (``nn1_mma`` once a pair, ``nn1_scan`` once an ICP step);
     hold each kernel against the plain version again on pair 0's own
     feature-match (``nn1_mma``) and ICP (``nn1_scan``, bit for bit)
     inputs, and time there the kernel, the plain version and one PyTorch
     library call computing the same function;
     then the stage breakdown, the RANSAC branch, the bf16 forward against
     the f32 one, and the card against the CPU's plain path on a small pair;
  5. the bench pairs again with ``icp_candidates="on"`` (candidate-list ICP
     and its checked fallback), held to the same pose limits;
  6. the staged API on bench pair 0 (``preprocess`` through
     ``safeguard_registration`` with the feature-matching safeguard, then
     the ICP polish), then ``register()`` with ``knn_search_method="cpu"``,
     both held to the bench's pose limits;
  7. ``register()`` at the KITTI-scale configuration (``lidar_like_pair``,
     120k points, 0.3 m voxel, conv1=5, dense extent 384x384x48, bf16,
     seeded random weights): a warm-up pair and pairs 0..2, each of which
     must take candidate-list ICP; the icp stage again with
     ``icp_candidates="off"`` and once more with "auto"; the 1-NN kernels at
     that scale's shapes;
     candidate against full-scan ICP on pair 0 from a near-converged init
     (their poses must agree) and from a coarse init (the checked ICP must
     fall back to the full scan's exact answer);
  8. the batched 1-NN kernels (``nn1_scan_batched``, ``nn1_mma_batched``)
     on random ragged batches (a pair with num1 = 0, one with num0 = 0):
     each pair bit for bit its unbatched launch, which is held to the plain
     version as in phase 2;
  9. ``register_batch(..., force_vmapped=True)`` at the bench configuration:
     the four bench pairs as one sub-batch after a warm-up call, held to the
     bench's pose limits and against ``register()`` beside two
     ``register()`` calls' own spread; the batched kernels at that path's
     match and ICP-scan shapes (bit for bit the unbatched launches, timed
     beside the unbatched launches, the plain version, ``torch.cdist`` and
     the bound); ``bench.py``'s 8-pair stream (two sub-batches) against
     ``register_many`` in turns, with each run's peak memory; one profiled
     batch call;
 10. ``register_batch`` on the three KITTI-scale pairs (the 65536 bucket, so
     candidate-list ICP without the checked wrapper): finite poses, a rerun
     for exactly the pairs whose gate bit or ``cand_ok`` is false, the time
     of the batched program apart from the reruns;
 11. the models: every entry of ``models.load_model``'s registry (47) at
     its published widths, a bf16 forward over bench pair 0, finite and
     timed; six representatives (SimpleNetBN2C, SimpleNetIN2,
     ResUNetBN2Cv2, ResUNetBN2SPC, ResUNetINBNSPC, PyramidNet6INBN) with
     non-trivial BN statistics, the card's f32 forward (BN folded) against
     the CPU's (BN live); ``register()`` from ``default_config()``
     (SimpleNetBN2C, 2.5 cm, random nets) on the four bench pairs; the
     bench weights written as reference-schema ``.pth`` files, whose nets
     must equal the ``.pkl``-built ones bit for bit, and ``register()`` from
     the ``.pth`` held to the bench's pose limits;
 12. print one JSON line describing every kernel, the card's line, and as
     the last line ``{"ok": true, "device": {...}}``.

Each path (4-7, 9, 10, 11's default configuration and .pth runs) is driven with the kernels' launch counts set to 0 just
before it and read just after; launches made to compare a kernel with its
plain version are not counted. Imports nothing of JAX. Exits non-zero when
no CUDA device is visible.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "fcgf_synthetic.pkl"
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense tensor cores
PEAK_BYTES = 3.35e12
# Kernel A (nn1_scan) against the plain version: 2 f32 ulps of |a|^2 +
# |b|^2. Both sides sum the norms in channel order; the kernel sums its
# cross term as an FMA chain, the plain version in the order the f32 GEMM
# picks, which may move it by an ulp or so of the terms. On the ICP-scan
# inputs of the main path it must agree bit for bit. Kernel B (nn1_mma,
# 3xTF32) is held to knn.MMA_D2_RTOL (2^-20) of |a|^2 + |b|^2 against the
# exact f64 d2 of the row it picks. Index mismatches must be near-ties
# (exact d2 within the tolerance), on at most NEAR_TIE_SHARE of the rows;
# where an input holds more (the KITTI random-weight features: the plain
# version itself misses the exact f64 argmin on ~7e-4 of the rows), kernel B
# must miss the exact argmin on no more rows than the plain version does.
D2_RTOL = 2.0 ** -22
NEAR_TIE_SHARE = 1e-4
# Pose limits of bench.py:86-91.
RRE_DEG, RTE_M = 1.0, 0.10
BENCH = dict(feat_model="ResUNetBN2C", feat_model_n_out=32,
             feat_conv1_kernel_size=7, inlier_model="ResUNetBN2C",
             inlier_conv1_kernel_size=3, voxel_size=0.05,
             inlier_feature_type="ones", weights=str(WEIGHTS),
             dense_extent="256,256,256")
# tools/kitti_scale_smoke.py:56-60 (no released weights: seeded random nets).
KITTI = dict(feat_model="ResUNetBN2C", feat_model_n_out=32,
             feat_conv1_kernel_size=5, inlier_model="ResUNetBN2C",
             inlier_conv1_kernel_size=3, voxel_size=0.3,
             inlier_feature_type="ones", dense_extent="384,384,48")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nn1_bound_ms(n0, n1, c: int, tensor_cores: bool = False):
    """(ms, by): the larger of the operations' and the bytes' time. The f32
    bound counts N0 N1 (2C + 3) operations (dot product FMAs, d2 formula,
    compare) at 67 TFLOP/s; the tensor-core bound 3 x 2 N0 N1 C (three TF32
    products) at 495 TFLOP/s. For a batch, n0 and n1 are the pairs' counts
    and the work is summed over the pairs."""
    pairs = list(zip(n0, n1)) if isinstance(n0, (list, tuple)) else [(n0, n1)]
    ops = sum(3 * 2 * a * b * c if tensor_cores else a * b * (2 * c + 3)
              for a, b in pairs)
    t_ops = ops / (PEAK_TF32_FLOPS if tensor_cores else PEAK_F32_FLOPS)
    t_bytes = sum((a + b) * c * 4 + a * 8 for a, b in pairs) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_nn1(knn, F0, F1, num0, num1, exact: bool, label: str,
              bitwise: bool = False) -> dict:
    """The width's kernel against the plain version on one input; returns
    the comparison's numbers. ``exact``: indices equal on every row (exact
    duplicates); ``bitwise``: indices and d2 equal bit for bit (kernel A on
    the main path's ICP scans)."""
    mma = F0.shape[1] > knn.SCAN_MAX_C
    kernel = knn.nn1_mma if mma else knn.nn1_scan
    i_k, d_k = kernel(F0, F1, num0, num1)
    torch.cuda.synchronize()
    i_p, d_p = knn.find_nn_plain(F0, F1, num0, num1)
    if not torch.equal(torch.isinf(d_k), torch.isinf(d_p)):
        fail(f"nn1 {label}: rows without a candidate differ")
    fin = torch.isfinite(d_p)
    f0, f1 = F0.double(), F1.double()
    n0sq = (f0 * f0).sum(1)

    def d2_exact(i, rows=slice(None)):
        return ((f0[rows] - f1[i[rows].long()]) ** 2).sum(1)

    err = (d_k.double() - d_p.double()).abs()
    max_err = float(err[fin].max()) if bool(fin.any()) else 0.0
    if mma:  # against the exact d2 of the kernel's own row
        tol = knn.MMA_D2_RTOL
        scale = n0sq + (f1[i_k.long()] ** 2).sum(1)
        rel = (d_k.double() - d2_exact(i_k)).abs() / scale.clamp_min(1e-30)
    else:
        tol = D2_RTOL
        scale = n0sq + (f1[i_p.long()] ** 2).sum(1)
        rel = err / scale.clamp_min(1e-30)
    max_rel = float(rel[fin].max()) if bool(fin.any()) else 0.0
    if max_rel > tol:
        fail(f"nn1 {label}: d2 off by {max_rel:.3e} of |a|^2 + |b|^2 "
             f"(tolerance {tol:.3e})")
    diff = (i_k != i_p).nonzero()[:, 0]
    if (exact or bitwise) and diff.numel():
        fail(f"nn1 {label}: {diff.numel()} index mismatches")
    if bitwise and max_err != 0.0:
        fail(f"nn1 {label}: d2 differs from the plain version by {max_err:.3e}")
    if diff.numel():
        gap = (d2_exact(i_k, diff) - d2_exact(i_p, diff)).abs()
        if bool((gap > tol * scale[diff]).any()):
            fail(f"nn1 {label}: an index mismatch is not a near-tie")
    r = {"max_abs_err": max_err, "near_ties": int(diff.numel()),
         "max_err_of_tolerance": max_rel / tol}
    if diff.numel() > max(1, int(NEAR_TIE_SHARE * num0)):
        # More near-ties than the share allows: the input itself is dense in
        # ties (e.g. random-weight features), so the plain version misses
        # the exact argmin there too. Kernel B may then miss it no more often.
        exact_i = argmin_f64(f0[:num0], f1[:num1])
        r["plain_misses_f64_argmin"] = int((i_p[:num0].long() != exact_i).sum())
        r["kernel_misses_f64_argmin"] = int((i_k[:num0].long() != exact_i).sum())
        if not mma or r["kernel_misses_f64_argmin"] > r["plain_misses_f64_argmin"]:
            fail(f"nn1 {label}: {diff.numel()} near-tie rows exceed "
                 f"{NEAR_TIE_SHARE} of {num0}; against the exact f64 argmin: {r}")
    print(f"nn1 {label} ({kernel.__name__}): rows {F0.shape[0]}x{F1.shape[0]} "
          f"C={F0.shape[1]} num0={num0} num1={num1} near-tie rows {diff.numel()} "
          f"max |d2 - plain| {max_err:.3e}, max d2 error {max_rel / tol:.3f} of "
          f"the tolerance {r}", flush=True)
    return r


def argmin_f64(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """The exact nearest row of f1 for each f0 row, in f64 (first index on
    ties), over candidate tiles."""
    sq0, sq1 = (f0 * f0).sum(1), (f1 * f1).sum(1)
    best = torch.full_like(sq0, float("inf"))
    idx = torch.zeros(f0.shape[0], dtype=torch.long, device=f0.device)
    for s in range(0, f1.shape[0], 2048):
        d = sq0[:, None] - 2.0 * f0 @ f1[s:s + 2048].T + sq1[None, s:s + 2048]
        m, a = d.min(1)
        upd = m < best
        best, idx = torch.where(upd, m, best), torch.where(upd, a + s, idx)
    return idx


def phase_kernels(knn) -> dict:
    """Each kernel against the plain version on random inputs at the bench's
    row counts, at its widths (A: C = 3, 8; B: C = 9, 32, 64): full, ragged,
    no candidate, and exact duplicates; returns each kernel's max
    |d2 - plain|."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    max_err = {"nn1_scan": 0.0, "nn1_mma": 0.0}
    for c in (3, 8, 9, 32, 64):
        name = "nn1_scan" if c <= knn.SCAN_MAX_C else "nn1_mma"
        F0 = torch.randn(14400, c, device="cuda", generator=g)
        F1 = torch.randn(14400, c, device="cuda", generator=g)
        checks = [(F0, F1, n0, n1, False, f"random C={c}")
                  for n0, n1 in ((14400, 14400), (14000, 13001), (14400, 0))]
        base = torch.randn(1000, c, device="cuda", generator=g)
        F1d = base.repeat(8, 1).contiguous()  # every row duplicated 8x
        F0d = F1d[torch.randperm(8000, device="cuda", generator=g)].contiguous()
        checks.append((F0d, F1d, 8000, 8000, True, f"duplicates C={c}"))
        for args in checks:
            max_err[name] = max(max_err[name], check_nn1(knn, *args)["max_abs_err"])
    return max_err


def time_nn1(knn, F0, F1, label: str, bitwise: bool = False) -> dict:
    """Kernel vs plain on one main-path input, then the kernel's, the plain
    version's and one library call's time on it, beside its bound(s). The
    kernel's ``ms`` is a CUDA graph replay of 50 calls (pre-pass, scan and
    decode; no host time between them), ``eager_ms`` back-to-back calls."""
    from deepglobalregistration_tpu_torch.tools.gather_bench import time_ms

    n0, n1, c = F0.shape[0], F1.shape[0], F0.shape[1]
    mma = c > knn.SCAN_MAX_C
    kernel = knn.nn1_mma if mma else knn.nn1_scan
    r = check_nn1(knn, F0, F1, n0, n1, False, label, bitwise=bitwise)
    r["kernel"] = kernel.__name__
    r["ms"] = time_ms(lambda: kernel(F0, F1, n0, n1))
    r["eager_ms"] = cuda_ms(lambda: kernel(F0, F1, n0, n1))
    r["plain_ms"] = cuda_ms(lambda: knn.find_nn_plain(F0, F1, n0, n1), 5)
    r["library_ms"] = cuda_ms(lambda: torch.cdist(F0, F1).argmin(1), 5)
    r["bound_ms"], r["bound_by"] = nn1_bound_ms(n0, n1, c, tensor_cores=mma)
    bounds = f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}"
    if mma:
        r["bound_f32_ms"], _ = nn1_bound_ms(n0, n1, c)
        bounds += f", tensor cores; f32 non-tensor {r['bound_f32_ms']:.4f} ms"
    r["shape"] = f"{n0}x{n1} C={c}"
    print(f"nn1 {label} {r['shape']} ({kernel.__name__}): kernel {r['ms']:.4f} ms "
          f"(eager {r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"torch.cdist+argmin {r['library_ms']:.4f} ms, {bounds})", flush=True)
    return r


def check_nn1_batched(knn, F0, F1, num0, num1, label: str,
                      against_plain: bool = True) -> dict:
    """The width's batched kernel on [B, N, C] inputs with per-pair counts:
    each pair's (idx, d2) must equal the unbatched kernel's on that pair bit
    for bit (all rows, padding included), and (``against_plain``) each
    unbatched result must meet ``check_nn1``'s tolerances against the plain
    version; returns the max |d2 - plain| over the pairs."""
    mma = F0.shape[-1] > knn.SCAN_MAX_C
    kernel = knn.nn1_mma_batched if mma else knn.nn1_scan_batched
    single = knn.nn1_mma if mma else knn.nn1_scan
    i_b, d_b = kernel(F0, F1, knn.pair_counts(num0, num1, F0.device))
    torch.cuda.synchronize()
    err = 0.0
    for p in range(F0.shape[0]):
        i_s, d_s = single(F0[p], F1[p], num0[p], num1[p])
        torch.cuda.synchronize()
        if not (torch.equal(i_b[p], i_s) and torch.equal(d_b[p].view(torch.int32),
                                                          d_s.view(torch.int32))):
            fail(f"nn1 batched {label}: pair {p} differs from its unbatched launch")
        if against_plain:
            err = max(err, check_nn1(knn, F0[p], F1[p], num0[p], num1[p], False,
                                     f"{label} pair {p}")["max_abs_err"])
    print(f"nn1 batched {label} ({kernel.__name__}): {tuple(F0.shape)} x "
          f"{tuple(F1.shape)}, num0 {list(num0)}, num1 {list(num1)}: every pair "
          "bit for bit its unbatched launch", flush=True)
    return {"max_abs_err": err}


def phase_batch_kernels_random(knn) -> dict:
    """Both batched kernels on random ragged batches at the bench's row
    counts (C = 3 and 32; a full pair, ragged pairs, num1 = 0 and num0 = 0)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    num0, num1 = [14400, 13001, 14000, 0], [15300, 15000, 0, 9000]
    err = {}
    for c in (3, 32):
        F0 = torch.randn(4, 14400, c, device="cuda", generator=g)
        F1 = torch.randn(4, 15300, c, device="cuda", generator=g)
        name = "nn1_mma_batched" if c > knn.SCAN_MAX_C else "nn1_scan_batched"
        err[name] = check_nn1_batched(knn, F0, F1, num0, num1,
                                      f"random ragged C={c}")["max_abs_err"]
    return err


def reset_counts(knn) -> None:
    knn.find_nn_cuda.launches = knn.nn1_scan.launches = knn.nn1_mma.launches = 0
    knn.nn1_scan_batched.launches = knn.nn1_mma_batched.launches = 0


def counts(knn) -> dict:
    return {"nn1_scan": knn.nn1_scan.launches, "nn1_mma": knn.nn1_mma.launches,
            "total": knn.find_nn_cuda.launches,
            "nn1_scan_batched": knn.nn1_scan_batched.launches,
            "nn1_mma_batched": knn.nn1_mma_batched.launches}


def pose_errors(T, T_gt):
    cos = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
    return (float(np.rad2deg(np.arccos(np.clip(cos, -1.0, 1.0)))),
            float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])))


def _host_ms(fn, reps: int = 3):
    """Mean host-clock ms of fn() between device synchronisations."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def _median_ms(fn, reps: int):
    """Median host-clock ms of ``reps`` fn() calls, each synchronised, after
    one warm-up call; returns it with the last call's output."""
    out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), out


def breakdown(dgr, pair, sec_per_pair: float, label: str = "bench") -> None:
    """Plan builds against network compute, and the device's busy share of
    one register() call (torch.profiler's CUDA kernel time over wall time)."""
    from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan
    from deepglobalregistration_tpu_torch.ops import knn, sparse_grid

    x0, x1 = dgr._as_tensor(pair[0]), dgr._as_tensor(pair[1])
    g0 = sparse_grid.voxelize(x0, dgr.voxel_size, 0)[1]
    g1 = sparse_grid.voxelize(x1, dgr.voxel_size, 1)[1]
    f, i = dgr.fcgf_cfg, dgr.inlier_cfg
    grid = torch.cat([g0, g1])
    ms_plan3, plan3 = _host_ms(lambda: build_unet_plan(
        grid, 2, f.conv1_kernel_size, f.region_type, f.levels,
        dense_extent=dgr.dense_extent, ones_input=True))
    ones = torch.ones((grid.shape[0], 1), dtype=dgr.compute_dtype, device=grid.device)
    ms_net3, feats = _host_ms(lambda: dgr.fcgf(plan3, ones))
    feats = feats.float()
    n0 = g0.shape[0]
    idx1 = knn.find_nn(feats[:n0], feats[n0:])[0].long()
    c6 = torch.cat([torch.zeros_like(g0[:, :1]), g0[:, 1:], g1[idx1, 1:]], dim=1)
    ms_plan6, plan6 = _host_ms(lambda: build_unet_plan(
        c6, 1, i.conv1_kernel_size, i.region_type, i.levels))
    ones6 = torch.ones((n0, 1), dtype=dgr.compute_dtype, device=grid.device)
    ms_net6, _ = _host_ms(lambda: dgr.inlier(plan6, ones6))
    edges3 = sum(em.n_edges for em in plan3.selfs + plan3.downs + plan3.ups)
    edges6 = sum(em.n_edges for em in plan6.selfs + plan6.downs + plan6.ups)
    print(json.dumps({
        "config": label,
        "rows_3d": [int(g.shape[0]) for g in plan3.grids],
        "rows_6d": [int(g.shape[0]) for g in plan6.grids],
        "edges_3d_k3_maps": edges3, "edges_6d_k3_maps": edges6,
        "fcgf_plan_ms": ms_plan3, "fcgf_net_ms": ms_net3,
        "inlier_plan_ms": ms_plan6, "inlier_net_ms": ms_net6}), flush=True)

    busy = profile_busy(lambda: dgr.register(pair[0], pair[1]), sec_per_pair)
    if busy is not None:
        print(json.dumps({"config": label, **busy}), flush=True)


def profile_busy(fn, unprofiled_s: float) -> dict | None:
    """One fn() under torch.profiler: its wall time, the CUDA kernels' busy
    time and launches, the top ten kernels, and the busy share over the
    profiled wall time and over ``unprofiled_s`` (the same work's time
    without the profiler). None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel rows only (operator rows repeat their kernels' device time).
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if dev_ms <= 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return None
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {"profiled_wall_ms": wall * 1e3, "device_kernel_ms": dev_ms,
            "device_busy_share_profiled": dev_ms / (wall * 1e3),
            "device_busy_share_unprofiled": dev_ms / (unprofiled_s * 1e3),
            "device_kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3
                               for e in top}}


def safeguard(dgr, pair) -> None:
    """The gate's other branch, which the bench pairs do not take: RANSAC on
    pair 0's feature correspondences, on the card and on the CPU with the
    same hypothesis draws, then ICP from the RANSAC pose."""
    from deepglobalregistration_tpu_torch.ops import icp, knn, ransac, se3

    x0, x1 = dgr._as_tensor(pair[0]), dgr._as_tensor(pair[1])
    with torch.no_grad():
        sel0, sel1, _, _, f0, f1, _ = dgr.features(x0, x1)
        X, Y = sel0, sel1[knn.find_nn(f0, f1)[0].long()]
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        samples = torch.randint(0, X.shape[0], (dgr.ransac_hypotheses, 4),
                                generator=g, device="cuda")
        thresh = 2 * dgr.voxel_size
        ms, res = _host_ms(lambda: ransac.ransac_correspondence(
            X, Y, thresh, samples=samples))
        ref = ransac.ransac_correspondence(X.cpu(), Y.cpu(), thresh,
                                           samples=samples.cpu())
        T = icp.registration_icp(sel0, sel1, thresh,
                                 init=se3.rt_to_matrix(res.R, res.t)).T
    gap = max(float((res.R.cpu() - ref.R).abs().max()),
              float((res.t.cpu() - ref.t).abs().max()))
    rre, rte = pose_errors(T.double().cpu().numpy(), pair[2])
    print(json.dumps({"ransac_ms": ms, "hypotheses": dgr.ransac_hypotheses,
                      "correspondences": int(X.shape[0]),
                      "fitness": float(res.fitness), "card_vs_cpu_max_abs": gap,
                      "ransac_icp_rre_deg": rre, "ransac_icp_rte_cm": rte * 100}),
          flush=True)
    if gap > 1e-3:
        fail(f"RANSAC on the card and on the CPU disagree by {gap:.3e}")
    if rre > 1.0 or rte > 0.10:
        fail(f"RANSAC + ICP pose off: rre {rre:.3f} deg, rte {rte * 100:.2f} cm")


def phase_end_to_end(knn) -> dict:
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import (
        STAGES, DeepGlobalRegistration)
    from deepglobalregistration_tpu_torch.ops import se3
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    if not WEIGHTS.exists():
        fail(f"missing {WEIGHTS}")
    bench = BENCH
    t0 = time.time()
    dgr = DeepGlobalRegistration(default_config(bf16=True, **bench), device="cuda")
    print(f"e2e: construction {time.time() - t0:.3f} s (inlier_trained="
          f"{dgr.inlier_trained})", flush=True)
    pairs = [synthetic_pair(n=30000, seed=s) for s in range(4)]
    t0 = time.time()
    dgr.register(pairs[0][0], pairs[0][1])  # warm-up
    torch.cuda.synchronize()
    print(f"e2e: warm-up pair {time.time() - t0:.3f} s", flush=True)

    dgr.feat_timer.reset()
    for t in dgr.stage_timers.values():
        t.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn)
    t0 = time.time()
    Ts, branches, iters = [], [], []
    for xyz0, xyz1, _ in pairs:
        Ts.append(dgr.register(xyz0, xyz1))
        branches.append(dgr.last_branch)
        iters.append(dgr.last_iterations)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / len(pairs)
    launches = counts(knn)
    errs = [pose_errors(T, p[2]) for T, p in zip(Ts, pairs)]
    rre = float(np.mean([e[0] for e in errs]))
    rte = float(np.mean([e[1] for e in errs]))
    stages = {s: dgr.stage_timers[s].avg for s in STAGES}
    print(json.dumps({
        "sec_per_pair": dt, "pairs_per_sec": 1.0 / dt,
        "feat_stage_sec": dgr.feat_timer.avg, "stage_sec": stages,
        "rre_deg": rre, "rte_cm": rte * 100,
        "rre_deg_per_pair": [e[0] for e in errs],
        "rte_cm_per_pair": [e[1] * 100 for e in errs],
        "branch_per_pair": branches, "iterations_per_pair": iters,
        "overflow_pairs": dgr.overflow_count,
        "nn1_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)
    if not all(np.isfinite(T).all() and T.shape == (4, 4) for T in Ts):
        fail("non-finite or misshapen transform")
    if rre > RRE_DEG or rte > RTE_M:
        fail(f"accuracy: mean rre {rre:.3f} deg / rte {rte * 100:.2f} cm "
             "(limits 1 deg / 10 cm)")
    if dgr.overflow_count:
        fail(f"{dgr.overflow_count} bench pairs overflow the JAX package's "
             "capacities (expected 0)")
    if launches["total"] < 2 * len(pairs):
        fail(f"nn1 kernels launched {launches} times for {len(pairs)} pairs "
             "(expected >= 2 per pair)")
    # One feature match a pair (nn1_mma), one scan an ICP step (nn1_scan).
    icp_steps = sum(i.get("icp", 0) for i in iters)
    if launches["nn1_mma"] < len(pairs) or launches["nn1_scan"] < icp_steps:
        fail(f"nn1 launches {launches}: expected nn1_mma >= {len(pairs)} and "
             f"nn1_scan >= {icp_steps} (the ICP steps)")

    # The kernel at the main path's own shapes and data: pair 0's feature
    # match, and its last ICP scan (the source moved by the final pose).
    x0, x1 = dgr._as_tensor(pairs[0][0]), dgr._as_tensor(pairs[0][1])
    with torch.no_grad():
        sel0, sel1, _, _, a0, a1, _ = dgr.features(x0, x1)
    moved = se3.apply_transform(
        sel0, torch.as_tensor(Ts[0], dtype=torch.float32, device="cuda"))
    timings = [time_nn1(knn, a0, a1, "feature match (pair 0)"),
               time_nn1(knn, moved.contiguous(), sel1, "ICP scan (pair 0)",
                        bitwise=True)]

    breakdown(dgr, pairs[0], dt)
    safeguard(dgr, pairs[0])
    # The same branch through register(): every weight clipped to 0 fails the
    # gate, so RANSAC draws from the instance's generator on the card.
    dgr_r = DeepGlobalRegistration(
        default_config(bf16=True, clip_weight_thresh=1.0, **bench), device="cuda")
    rre_r, rte_r = pose_errors(dgr_r.register(pairs[0][0], pairs[0][1]), pairs[0][2])
    print(f"register() on the RANSAC branch, pair 0: {dgr_r.last_branch}, rre "
          f"{rre_r:.4f} deg, rte {rte_r * 100:.4f} cm", flush=True)
    if dgr_r.last_branch != "ransac" or rre_r > 1.0 or rte_r > 0.10:
        fail("register() on the RANSAC branch did not register pair 0")

    # bf16 convs against f32 convs on pair 0 (same weights, same inputs).
    dgr32 = DeepGlobalRegistration(default_config(bf16=False, **bench), device="cuda")
    with torch.no_grad():
        _, _, _, _, b0, b1, _ = dgr32.features(x0, x1)
    cos = torch.nn.functional.cosine_similarity(torch.cat([a0, a1]),
                                                torch.cat([b0, b1]), dim=1)
    match = (knn.find_nn(a0, a1)[0] == knn.find_nn(b0, b1)[0]).float().mean()
    print(f"bf16 vs f32 FCGF on pair 0: feature cosine mean {float(cos.mean()):.6f} "
          f"min {float(cos.min()):.6f}; 1-NN index agreement {float(match):.6f}",
          flush=True)

    # The card against the CPU's plain path on a small pair.
    small = dict(feat_model="ResUNetBN2F", feat_model_n_out=8,
                 feat_conv1_kernel_size=3, inlier_model="ResUNetBN2FX",
                 inlier_conv1_kernel_size=3, voxel_size=0.05,
                 inlier_feature_type="ones", point_buckets="512,1024",
                 ransac_hypotheses=512, level_shrink=1)
    rng = np.random.RandomState(0)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    shift = np.array([8, -8, 16], np.float32) * 0.05
    T_gpu = DeepGlobalRegistration(default_config(**small), "cuda").register(xyz, xyz + shift)
    T_cpu = DeepGlobalRegistration(default_config(**small), "cpu").register(xyz, xyz + shift)
    gap = float(np.abs(T_gpu - T_cpu).max())
    print(f"small pair: card vs CPU plain path max |dT| {gap:.3e}", flush=True)
    if gap > 1e-3:
        fail("card and CPU disagree on the small pair beyond 1e-3")
    return {"launches": launches, "timings": timings, "pairs": pairs}


def gather_bound_ms(n: int, words: int, ops_per_index: int):
    """Bound of one probe gather: N int32 indices read, N int32 words written
    and the W-word table read once, against ``ops_per_index`` integer
    operations an index at the non-tensor 67 TOP/s rate."""
    t_bytes = (8 * n + 4 * words) / PEAK_BYTES
    t_ops = n * ops_per_index / PEAK_F32_FLOPS
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_gather() -> list:
    """The gather probe at each of its shapes (the bench's and the KITTI
    scale's) as a path of its own, launch counts set to 0 just before each
    shape and read just after; then each kernel against its plain version
    bit for bit at each shape's N and N - 1 (and N = 1 at the bench's) and
    on the view idx[1:], 4 bytes past the indices' start, and the plain
    versions' times."""
    from deepglobalregistration_tpu_torch.ops import gather
    from deepglobalregistration_tpu_torch.tools import gather_bench as gb

    probes, launches = {}, {}
    for shape, (words, n) in gb.SHAPES.items():
        gather.take_cuda.launches = gather.take2d_cuda.launches = 0
        probes[shape] = gb.run("cuda", words=words, n=n)
        launches[shape] = {"take": gather.take_cuda.launches,
                           "take2d": gather.take2d_cuda.launches}
        print(json.dumps({"gather_probe": probes[shape], "shape": shape,
                          "gather_launches": launches[shape]}), flush=True)
        if not (probes[shape]["take_exact"] and probes[shape]["take2d_exact"]):
            fail(f"the gather probe ({shape}) found a kernel that is not exact")
        if min(launches[shape].values()) < 1:
            fail(f"a gather kernel was not launched by the {shape} probe: "
                 f"{launches[shape]}")

    entries = []
    for name, kernel, plain, ops, line in (
            ("take", gather.take_cuda, gather.take_plain, 1, 44),
            ("take2d", gather.take2d_cuda, gather.take2d_plain, 3, 64)):
        entry = {"name": f"gather_{name}", "route": "cuda",
                 "source": "deepglobalregistration_tpu_torch/csrc/gather.cu",
                 "replaces": f"tools/pallas_gather_bench.py:{line}",
                 "max_abs_err": 0}
        for shape, (words, n) in gb.SHAPES.items():
            table, idx = gb.make_inputs(words, n, device="cuda")
            tab = table.view(-1, gather.LANES) if name == "take2d" else table
            views = [(0, n), (0, n - 1), (1, n)]
            if shape == "bench":
                views.append((0, 1))
            for a, b in views:
                got, want = kernel(tab, idx[a:b]), plain(tab, idx[a:b])
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"gather {name} ({shape}): kernel and plain version "
                         f"differ on idx[{a}:{b}]")
                entry["max_abs_err"] = max(
                    entry["max_abs_err"], int((got.long() - want.long()).abs().max()))
            bound, by = gather_bound_ms(n, words, ops)
            sfx = "" if shape == "bench" else f"_{shape}"
            entry.update({
                f"launches{sfx}": launches[shape][name],
                f"ms{sfx}": probes[shape][f"{name}_ms"],
                f"plain_ms{sfx}": gb.time_ms(lambda: plain(tab, idx)),
                f"bound_ms{sfx}": bound, f"bound_by{sfx}": by,
                f"library_ms{sfx}": probes[shape]["table_index_ms"]})
            print(f"gather {name} ({shape}, W={words}, N={n}): kernel "
                  f"{entry[f'ms{sfx}']:.6f} ms, plain {entry[f'plain_ms{sfx}']:.6f} "
                  f"ms, table[idx] {entry[f'library_ms{sfx}']:.6f} ms, bound "
                  f"{bound:.6f} ms ({by}), launches {launches[shape][name]}",
                  flush=True)
        entry.update({
            "shape": "table W int32 words, N indices: bench W={} N={}; *_kitti: "
                     "W={} N={} (each also checked at N - 1 and on idx[1:], the "
                     "bench at N = 1)".format(*gb.SHAPES["bench"], *gb.SHAPES["kitti"]),
            "bound_formula": f"max((8 N + 4 W) B / 3.35 TB/s, {ops} N ops / 67 TOP/s)",
            "clock": probes["bench"]["clock"]})
        entries.append(entry)
    return entries


def phase_bench_candidates(knn, pairs) -> int:
    """The bench pairs with icp_candidates="on": candidate-list ICP and its
    checked fallback, held to the bench's pose limits."""
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration

    dgr = DeepGlobalRegistration(
        default_config(bf16=True, icp_candidates="on", **BENCH), device="cuda")
    dgr.register(pairs[0][0], pairs[0][1])  # warm-up
    dgr.cand_fallbacks = 0
    reset_counts(knn)
    errs, modes = [], []
    for xyz0, xyz1, T_gt in pairs:
        errs.append(pose_errors(dgr.register(xyz0, xyz1), T_gt))
        modes.append(dgr.last_iterations["icp_mode"])
    torch.cuda.synchronize()
    launches = counts(knn)
    rre = float(np.mean([e[0] for e in errs]))
    rte = float(np.mean([e[1] for e in errs]))
    print(json.dumps({"bench_icp_candidates_on": {
        "icp_mode_per_pair": modes, "cand_fallbacks": dgr.cand_fallbacks,
        "rre_deg": rre, "rte_cm": rte * 100, "nn1_launches": launches,
        "rre_deg_per_pair": [e[0] for e in errs],
        "rte_cm_per_pair": [e[1] * 100 for e in errs]}}), flush=True)
    if any(m != "candidates" for m in modes):
        fail(f"icp_candidates='on' did not take candidate ICP: {modes}")
    if rre > RRE_DEG or rte > RTE_M:
        fail(f"icp_candidates='on': mean rre {rre:.3f} deg / rte "
             f"{rte * 100:.2f} cm (limits 1 deg / 10 cm)")
    if launches["nn1_mma"] < len(pairs):
        fail(f"nn1 launches {launches} for {len(pairs)} pairs")
    return launches


def phase_staged(knn, pair) -> dict:
    """The staged API on bench pair 0 with the feature-matching safeguard at
    the reference's 80000-validation budget (clamped to 65536 hypotheses),
    followed by the ICP polish that register() applies to a safeguard pose,
    then register() with host KD-tree matching; both poses held to the
    bench's limits. The RANSAC-only pose is printed, not held: with ~5.5 %
    inlier matches, 65536 four-point draws hold ~0.6 all-inlier samples on
    average, so whether one lands within 1 deg is a matter of the draws."""
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.ops import icp

    xyz0, xyz1, T_gt = pair
    dgr = DeepGlobalRegistration(default_config(bf16=True, **BENCH), device="cuda")
    dgr.safeguard_method = "feature_matching"
    reset_counts(knn)
    t0 = time.perf_counter()
    x0, c0, f0 = dgr.preprocess(xyz0)
    x1, c1, f1 = dgr.preprocess(xyz1)
    feats0 = dgr.fcgf_feature_extraction(f0, c0)
    feats1 = dgr.fcgf_feature_extraction(f1, c1)
    i0, i1 = dgr.fcgf_feature_matching(feats0, feats1)
    ifeat = dgr.inlier_feature_generation(x0, x1, c0, c1, feats0, feats1, i0, i1)
    logits = dgr.inlier_prediction(ifeat, np.concatenate([c0[i0], c1[i1]], axis=1))
    T_staged = dgr.safeguard_registration(
        x0, x1, i0, i1, feats0, feats1, distance_threshold=2 * dgr.voxel_size,
        num_iterations=80000)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    staged_launches = counts(knn)
    T_polished = icp.registration_icp(
        dgr._as_tensor(x0), dgr._as_tensor(x1), 2 * dgr.voxel_size,
        init=torch.as_tensor(T_staged, dtype=torch.float32, device="cuda")).T

    dgr_cpu = DeepGlobalRegistration(
        default_config(bf16=True, knn_search_method="cpu", **BENCH), device="cuda")
    reset_counts(knn)
    t0 = time.perf_counter()
    T_cpu = dgr_cpu.register(xyz0, xyz1)
    cpu_s = time.perf_counter() - t0
    cpu_launches = counts(knn)
    e_staged, e_cpu = pose_errors(T_staged, T_gt), pose_errors(T_cpu, T_gt)
    e_pol = pose_errors(T_polished.double().cpu().numpy(), T_gt)
    print(json.dumps({"staged_feature_matching": {
        "voxels": [len(c0), len(c1)], "logits_finite": bool(np.isfinite(logits).all()),
        "hypotheses": 65536, "rre_deg": e_pol[0], "rte_cm": e_pol[1] * 100,
        "s": staged_s, "nn1_launches": staged_launches,
        "ransac_only_rre_deg": e_staged[0], "ransac_only_rte_cm": e_staged[1] * 100},
        "register_knn_cpu": {"rre_deg": e_cpu[0], "rte_cm": e_cpu[1] * 100,
                             "s_first_call": cpu_s, "branch": dgr_cpu.last_branch,
                             "nn1_launches": cpu_launches}}), flush=True)
    if logits.shape != (len(i0), 1) or not np.isfinite(logits).all():
        fail("staged inlier_prediction gave misshapen or non-finite logits")
    for name, (rre, rte) in (("staged feature_matching + ICP", e_pol),
                             ("knn_search_method='cpu'", e_cpu)):
        if rre > RRE_DEG or rte > RTE_M:
            fail(f"{name}: rre {rre:.3f} deg / rte {rte * 100:.2f} cm "
                 "(limits 1 deg / 10 cm)")
    # fcgf_feature_matching and ransac_feature_matching each match once (C =
    # 32); with host KD-tree matching only the ICP scans (C = 3) reach the card.
    if staged_launches["nn1_mma"] < 2 or cpu_launches["nn1_scan"] < 1:
        fail(f"nn1 launches: staged {staged_launches}, knn cpu {cpu_launches}")
    return {"staged": staged_launches, "knn_cpu": cpu_launches}


def _turn_z(T_gt: np.ndarray, deg: float, shift) -> torch.Tensor:
    """Ground truth composed with a turn about z and a shift (source frame)."""
    from scipy.spatial.transform import Rotation

    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = Rotation.from_euler("z", deg, degrees=True).as_matrix()
    P[:3, 3] = shift
    return torch.as_tensor(T_gt @ P, dtype=torch.float32, device="cuda")


def kitti_icp_check(sel0, sel1, T_gt, voxel) -> dict:
    """Candidate against full-scan ICP on one pair's voxelized clouds: from
    a near-converged init (0.05 deg about z and 3 cm off the ground truth,
    which moves the farthest point well inside the quarter-cell bound) their
    poses must agree within 1e-4; from a coarse init (5 deg off) the
    candidate lists go stale and the checked ICP must return the full scan's
    pose bit for bit. The iteration counts are printed, not held: at LiDAR
    ranges the scan's f32 |a|^2 - 2a.b + |b|^2 rounds by more than the 1e-6
    rmse stop rule, so it may stop later than the candidate path, as the
    JAX package's scan does (``tests/torch_port_icp_gap.py``)."""
    from deepglobalregistration_tpu_torch.ops import icp, se3

    mcd = 2 * voxel
    near = _turn_z(T_gt, 0.05, (0.03, 0.0, 0.0))
    T_gt_d = torch.as_tensor(T_gt, dtype=torch.float32, device="cuda")
    shift = float(torch.sqrt(((se3.apply_transform(sel0, near)
                               - se3.apply_transform(sel0, T_gt_d)) ** 2).sum(1)).max())
    moved0 = se3.apply_transform(sel0, near).contiguous()
    build_ms = cuda_ms(lambda: icp._build_candidates(moved0, sel1, cell=mcd), 5)
    cand_ms, cand = _host_ms(lambda: icp.registration_icp(
        sel0, sel1, mcd, init=near, use_candidates=True), 1)
    full_ms, full = _host_ms(lambda: icp.registration_icp(sel0, sel1, mcd, init=near), 1)
    dT = float((cand.T - full.T).abs().max())
    coarse = _turn_z(T_gt, 5.0, (0.0, 0.0, 0.0))
    checked_ms, checked = _host_ms(lambda: icp.registration_icp_checked(
        sel0, sel1, mcd, init=coarse), 1)
    full_c = icp.registration_icp(sel0, sel1, mcd, init=coarse)
    same = bool(torch.equal(checked.T, full_c.T))
    r = {"rows": [int(sel0.shape[0]), int(sel1.shape[0])],
         "near_init_max_shift_m": shift, "quarter_cell_m": 0.25 * mcd,
         "candidate_build_ms": build_ms,
         "near": {"cand_ms": cand_ms, "full_ms": full_ms, "cand_iters": cand.iterations,
                  "full_iters": full.iterations,
                  "iteration_gap": full.iterations - cand.iterations,
                  "cand_ok": cand.cand_ok,
                  "max_abs_dT": dT, "cand_rmse": cand.inlier_rmse,
                  "full_rmse": full.inlier_rmse},
         "coarse": {"checked_ms": checked_ms, "cand_ok": checked.cand_ok,
                    "iters": checked.iterations, "equals_full_scan": same}}
    print(json.dumps({"kitti_icp_check": r}), flush=True)
    if not cand.cand_ok or dT > 1e-4:
        fail(f"near-converged candidate ICP does not match the full scan: "
             f"cand_ok {cand.cand_ok}, max |dT| {dT:.3e}, iterations "
             f"{cand.iterations} vs {full.iterations}")
    if checked.cand_ok or not same:
        fail(f"coarse init: cand_ok {checked.cand_ok}, checked T equal to the "
             f"full scan's: {same}")
    return r


def phase_kitti(knn) -> dict:
    """register() at the KITTI-scale configuration, then the 1-NN kernel at
    its shapes and the ICP check on pair 0."""
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import (
        STAGES, DeepGlobalRegistration)
    from deepglobalregistration_tpu_torch.ops import se3
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    dgr = DeepGlobalRegistration(default_config(bf16=True, **KITTI), device="cuda")
    pairs = []
    for seed in range(3):
        xyz0, xyz1, R, t = lidar_like_pair(seed=seed)
        T_gt = np.eye(4, dtype=np.float32)
        T_gt[:3, :3], T_gt[:3, 3] = R, t
        pairs.append((xyz0, xyz1, T_gt))
    t0 = time.time()
    dgr.register(pairs[0][0], pairs[0][1])  # warm-up
    torch.cuda.synchronize()
    warm = time.time() - t0

    dgr.feat_timer.reset()
    for tm in dgr.stage_timers.values():
        tm.reset()
    dgr.cand_fallbacks = dgr.overflow_count = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(knn)
    Ts, branches, iters, falls = [], [], [], []
    t0 = time.time()
    for xyz0, xyz1, _ in pairs:
        before = dgr.cand_fallbacks
        Ts.append(dgr.register(xyz0, xyz1))
        branches.append(dgr.last_branch)
        iters.append(dict(dgr.last_iterations))
        falls.append(dgr.cand_fallbacks - before)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / len(pairs)
    launches = counts(knn)
    icp_auto_s = dgr.stage_timers["icp"].avg
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    errs = [pose_errors(T, p[2]) for T, p in zip(Ts, pairs)]
    x0, x1 = dgr._as_tensor(pairs[0][0]), dgr._as_tensor(pairs[0][1])
    with torch.no_grad():
        sel0, sel1, g0, g1, a0, a1, _ = dgr.features(x0, x1)
    print(json.dumps({"kitti": {
        "warm_up_s": warm, "sec_per_pair": dt, "feat_stage_sec": dgr.feat_timer.avg,
        "stage_sec": {s: dgr.stage_timers[s].avg for s in STAGES},
        "rows_level0_pair0": [int(g0.shape[0]), int(g1.shape[0])],
        "voxel_bucket": dgr._cap, "peak_mem_gib": peak,
        "icp_mode_per_pair": [i.get("icp_mode") for i in iters],
        "cand_fallbacks_per_pair": falls, "branch_per_pair": branches,
        "iterations_per_pair": iters, "overflow_pairs": dgr.overflow_count,
        "nn1_launches": launches,
        "informational_rre_deg": [e[0] for e in errs],
        "informational_rte_m": [e[1] for e in errs]}}), flush=True)
    if not all(np.isfinite(T).all() and T.shape == (4, 4) for T in Ts):
        fail("KITTI scale: non-finite or misshapen transform")
    if any(i.get("icp_mode") != "candidates" for i in iters):
        fail("KITTI scale: a pair did not take candidate-list ICP")
    # One feature match a pair (nn1_mma); each fallback runs the full scan.
    if launches["nn1_mma"] < len(pairs) or launches["nn1_scan"] < sum(falls):
        fail(f"KITTI scale: nn1 launches {launches} for {len(pairs)} pairs and "
             f"{sum(falls)} full-scan fallbacks")
    icp_modes = icp_auto_vs_off(dgr, pairs, icp_auto_s)

    moved = se3.apply_transform(
        sel0, torch.as_tensor(Ts[0], dtype=torch.float32, device="cuda"))
    timings = [time_nn1(knn, a0, a1, "KITTI feature match (pair 0)"),
               time_nn1(knn, moved.contiguous(), sel1, "KITTI fallback scan (pair 0)",
                        bitwise=True)]
    breakdown(dgr, pairs[0], dt, "kitti")
    icp_r = kitti_icp_check(sel0, sel1, pairs[0][2], dgr.voxel_size)
    return {"launches": launches, "timings": timings, "icp": icp_r,
            "icp_modes": icp_modes}


def icp_auto_vs_off(dgr, pairs, auto_s: float) -> dict:
    """register()'s icp stage on the KITTI pairs with icp_candidates="off"
    (the full scan only), then "auto" (candidate lists at the 65536 bucket,
    the checked fallback) once more, in the same call as the first "auto"
    run: whether the candidate path pays against the full scan."""
    r = {"icp_auto_s_per_pair": [auto_s]}
    for mode in ("off", "auto"):
        dgr.icp_candidates = mode
        dgr.stage_timers["icp"].reset()
        iters = []
        for xyz0, xyz1, _ in pairs:
            dgr.register(xyz0, xyz1)
            iters.append(dgr.last_iterations.get("icp"))
        torch.cuda.synchronize()
        r[f"icp_{mode}_s_per_pair"] = r.get(f"icp_{mode}_s_per_pair", []) + [
            dgr.stage_timers["icp"].avg]
        r[f"icp_{mode}_iterations"] = iters
    dgr.icp_candidates = "auto"
    print(json.dumps({"kitti_icp_auto_vs_off": r}), flush=True)
    return r


def time_nn1_batched(knn, F0, F1, num0, num1, label: str) -> dict:
    """The batched kernel on one main-path batch: its time (a CUDA graph
    replay, as ``time_nn1``), the sum of the unbatched kernel's times on the
    same pairs, the plain version's and one library call's
    (``torch.cdist`` + ``argmin`` over the padded [B, ...] tensors), beside
    the bound summed over the pairs' own counts."""
    from deepglobalregistration_tpu_torch.tools.gather_bench import time_ms

    c = F0.shape[-1]
    mma = c > knn.SCAN_MAX_C
    kernel = knn.nn1_mma_batched if mma else knn.nn1_scan_batched
    single = knn.nn1_mma if mma else knn.nn1_scan
    nums = knn.pair_counts(num0, num1, F0.device)
    r = {"kernel": kernel.__name__,
         "ms": time_ms(lambda: kernel(F0, F1, nums)),
         "unbatched_sum_ms": sum(time_ms(lambda p=p: single(F0[p], F1[p], num0[p], num1[p]))
                                 for p in range(F0.shape[0])),
         "plain_ms": cuda_ms(lambda: knn.find_nn_batched_plain(F0, F1, num0, num1), 3),
         "library_ms": cuda_ms(lambda: torch.cdist(F0, F1).argmin(-1), 3),
         "shape": f"{F0.shape[0]} pairs, num0 {list(num0)} x num1 {list(num1)}, C={c}"}
    r["bound_ms"], r["bound_by"] = nn1_bound_ms(list(num0), list(num1), c,
                                                tensor_cores=mma)
    print(f"nn1 batched {label} {r['shape']} ({kernel.__name__}): kernel "
          f"{r['ms']:.4f} ms, unbatched launches {r['unbatched_sum_ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, torch.cdist+argmin {r['library_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return r


def _check_batch_launches(r: dict, label: str) -> None:
    """One batched feature match a sub-batch, and with the full-scan ICP one
    batched scan an ICP step of the sub-batch's longest pair plus the
    evaluation of the init; the reruns' launches are register()'s own."""
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration

    m = DeepGlobalRegistration._MAX_SUB_BATCH
    lb, launches = r["last_batch"], r["launches"]
    subs = len(lb["cap"])
    want_scan = 0
    for s, mode in enumerate(lb["icp_mode"]):
        part = slice(m * s, m * s + m)
        icp = [i for i, g in zip(lb["icp"][part], lb["gate"][part]) if g]
        if mode == "full" and icp:
            want_scan += max(icp) + 1
    if launches["nn1_mma_batched"] != subs or launches["nn1_scan_batched"] != want_scan:
        fail(f"{label}: batched launches {launches}, expected nn1_mma_batched "
             f"{subs} and nn1_scan_batched {want_scan}")
    if launches["nn1_mma"] != sum(lb["rerun"]):
        fail(f"{label}: {sum(lb['rerun'])} reruns but nn1_mma launched "
             f"{launches['nn1_mma']} times")


def phase_batch(knn) -> dict:
    """register_batch(force_vmapped=True) at the bench configuration: the
    four bench pairs as one sub-batch (after a warm-up call), each pose held
    to the bench's limits and against register() on the same pair beside two
    register() calls' own spread; the batched kernels at that path's shapes;
    bench.py's 8-pair stream (two sub-batches) against register_many on the
    same pairs in the same call (turns: batch, many, many, batch); one
    profiled batch call."""
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.ops import se3
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    from deepglobalregistration_tpu_torch.tools import batch_bench

    dgr = DeepGlobalRegistration(default_config(bf16=True, **BENCH), device="cuda")
    pairs = [synthetic_pair(n=30000, seed=s) for s in range(4)]
    x0s, x1s = [p[0] for p in pairs], [p[1] for p in pairs]
    dgr.register_batch(x0s, x1s, force_vmapped=True)  # warm-up
    r4 = batch_bench.run_turn(dgr, "batch", x0s, x1s)
    lb = r4["last_batch"]
    errs = [pose_errors(T, p[2]) for T, p in zip(r4["T"], pairs)]
    rre = float(np.mean([e[0] for e in errs]))
    rte = float(np.mean([e[1] for e in errs]))
    Tr = [[dgr.register(*p[:2]) for p in pairs] for _ in range(2)]
    gap = [float(np.abs(Tb - T).max()) for Tb, T in zip(r4["T"], Tr[0])]
    spread = [float(np.abs(a - b).max()) for a, b in zip(*Tr)]
    out4 = {k: v for k, v in r4.items() if k != "T"}
    print(json.dumps({"batch_bench_4": {
        **out4, "rre_deg": rre, "rte_cm": rte * 100,
        "rre_deg_per_pair": [e[0] for e in errs],
        "rte_cm_per_pair": [e[1] * 100 for e in errs],
        "max_abs_T_batch_minus_register": gap,
        "max_abs_T_register_spread": spread}}), flush=True)
    if not all(np.isfinite(T).all() for T in r4["T"]) or r4["T"].shape != (4, 4, 4):
        fail("register_batch: non-finite or misshapen transforms")
    if rre > RRE_DEG or rte > RTE_M:
        fail(f"register_batch: mean rre {rre:.3f} deg / rte {rte * 100:.2f} cm "
             "(limits 1 deg / 10 cm)")
    _check_batch_launches(r4, "register_batch (bench, 4 pairs)")

    # The batched kernels at this path's shapes: the four pairs' features
    # (C = 32) and their last ICP scan (C = 3, each source at its pose).
    from torch.nn.utils.rnn import pad_sequence

    feats = [dgr.features(dgr._as_tensor(a), dgr._as_tensor(b)) for a, b in zip(x0s, x1s)]
    n0 = [int(f[0].shape[0]) for f in feats]
    n1 = [int(f[1].shape[0]) for f in feats]
    F0 = pad_sequence([f[4] for f in feats], batch_first=True).contiguous()
    F1 = pad_sequence([f[5] for f in feats], batch_first=True).contiguous()
    moved = pad_sequence([se3.apply_transform(f[0], torch.as_tensor(
        T, dtype=torch.float32, device="cuda")) for f, T in zip(feats, r4["T"])],
        batch_first=True).contiguous()
    S1 = pad_sequence([f[1] for f in feats], batch_first=True).contiguous()
    err = {"nn1_mma_batched": check_nn1_batched(knn, F0, F1, n0, n1,
                                                "bench feature match")["max_abs_err"],
           "nn1_scan_batched": check_nn1_batched(knn, moved, S1, n0, n1,
                                                 "bench ICP scan")["max_abs_err"]}
    timings = {"nn1_mma_batched": time_nn1_batched(knn, F0, F1, n0, n1,
                                                   "bench feature match"),
               "nn1_scan_batched": time_nn1_batched(knn, moved, S1, n0, n1,
                                                    "bench ICP scan")}

    # bench.py's stream: the four pairs twice, two sub-batches, in turns
    # with register_many on the same pairs.
    stream = [pairs[i % 4] for i in range(8)]
    cmp = batch_bench.compare(dgr, [p[0] for p in stream], [p[1] for p in stream])
    cmp.pop("T_batch")
    for t in cmp["turns"]:
        if t["kind"] == "batch":
            _check_batch_launches(t, "register_batch (bench stream, 8 pairs)")
    busy = profile_busy(lambda: dgr.register_batch(x0s, x1s, force_vmapped=True),
                        4 * r4["s_per_pair"])
    print(json.dumps({"batch_stream_8": {**cmp, "profiled_batch_4": busy}}), flush=True)
    return {"launches": r4["launches"], "max_abs_err": err, "timings": timings,
            "s_per_pair": cmp["mean_s_per_pair"]}


def phase_batch_kitti(knn) -> dict:
    """register_batch(force_vmapped=True) on the three KITTI-scale pairs
    (one sub-batch at the 65536 bucket, so candidate-list ICP without the
    checked wrapper) after a warm-up call: finite poses, and a rerun for
    exactly the pairs whose gate bit or cand_ok is false; the batched match
    kernel against its unbatched launches on those pairs' features."""
    from torch.nn.utils.rnn import pad_sequence

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    from deepglobalregistration_tpu_torch.tools import batch_bench

    dgr = DeepGlobalRegistration(default_config(bf16=True, **KITTI), device="cuda")
    pairs = [lidar_like_pair(seed=s)[:2] for s in range(3)]
    x0s, x1s = [p[0] for p in pairs], [p[1] for p in pairs]
    dgr.register_batch(x0s, x1s, force_vmapped=True)  # warm-up
    r = batch_bench.run_turn(dgr, "batch", x0s, x1s)
    lb = r["last_batch"]
    want = [not (g and c) for g, c in zip(lb["gate"], lb["cand_ok"])]
    print(json.dumps({"batch_kitti_3": {
        **{k: v for k, v in r.items() if k != "T"},
        "rerun_s": 3 * r["s_per_pair"] - r["batched_program_s"]}}), flush=True)
    if not np.isfinite(r["T"]).all():
        fail("register_batch at KITTI scale: non-finite transforms")
    if lb["cap"] != [65536] or lb["icp_mode"] != ["candidates"]:
        fail(f"register_batch at KITTI scale: bucket {lb['cap']}, ICP {lb['icp_mode']}")
    if lb["rerun"] != want:
        fail(f"register_batch at KITTI scale: reruns {lb['rerun']}, gate "
             f"{lb['gate']}, cand_ok {lb['cand_ok']}")
    _check_batch_launches(r, "register_batch (KITTI, 3 pairs)")
    feats = [dgr.features(dgr._as_tensor(a), dgr._as_tensor(b)) for a, b in pairs]
    n0 = [int(f[0].shape[0]) for f in feats]
    n1 = [int(f[1].shape[0]) for f in feats]
    F0 = pad_sequence([f[4] for f in feats], batch_first=True).contiguous()
    F1 = pad_sequence([f[5] for f in feats], batch_first=True).contiguous()
    check_nn1_batched(knn, F0, F1, n0, n1, "KITTI feature match", against_plain=False)
    return {"launches": r["launches"],
            "timing": time_nn1_batched(knn, F0, F1, n0, n1, "KITTI feature match")}


# Card against CPU (phase 11 b): f32 on both sides, TF32 off; features are
# unit rows, so the largest |card - CPU| of any entry is relative to the row.
MODELS_CARD_CPU_TOL = 1e-4
MODELS_CARD_CPU = ("SimpleNetBN2C", "SimpleNetIN2", "ResUNetBN2Cv2", "ResUNetBN2SPC",
                   "ResUNetINBNSPC", "PyramidNet6INBN")


def _family(cfg) -> str:
    """The registry family and structure of a model config."""
    name = type(cfg).__name__.replace("Config", "")
    fam = getattr(cfg, "family", None)
    return f"{name} {fam}" if fam else name


def _nontrivial_norms(params, state, rng):
    """BN scales around 1, biases around 0 and running statistics away from
    identity (the tests' ``numpy_tree`` rule), so that a BN left out shows."""
    for key, sub in params.items():
        if isinstance(sub, dict) and "weight" in sub:
            sub["weight"] = (1 + 0.2 * rng.randn(*sub["weight"].shape)).astype(np.float32)
            sub["bias"] = (0.1 * rng.randn(*sub["bias"].shape)).astype(np.float32)
            st = state[key]
            st["mean"] = (0.5 * rng.rand(*st["mean"].shape)).astype(np.float32)
            st["var"] = (1 + 0.5 * rng.rand(*st["var"].shape)).astype(np.float32)
        elif isinstance(sub, dict):
            _nontrivial_norms(sub, state.get(key, {}), rng)


def _plan(grid, batch_size, cfg, cache):
    from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan

    key = (grid.device.type, cfg.region_type, cfg.levels, cfg.with_pooling)
    if key not in cache:
        cache[key] = build_unet_plan(grid, batch_size, cfg.conv1_kernel_size,
                                     cfg.region_type, cfg.levels, ones_input=True,
                                     with_pooling=cfg.with_pooling)
    return cache[key]


def me_state_dict(params: dict, state: dict) -> dict:
    """(params, state) trees as a MinkowskiEngine state_dict, the layout of
    the reference's .pth files (the inverse of the port's
    ``checkpoint.convert_state_dict``): a norm's leaves under
    ``<scope>.bn.``, k1 kernels as [Cin, Cout], ``num_batches_tracked``
    beside each running mean."""
    sd = {}

    def walk(tree, prefix, is_state):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".", is_state)
                continue
            arr = np.asarray(v, np.float32)
            if is_state:
                sd[f"{prefix}bn.running_{k}"] = torch.from_numpy(arr.copy())
                if k == "mean":
                    sd[f"{prefix}bn.num_batches_tracked"] = torch.tensor(0)
            elif "weight" in tree:  # a norm's affine parameters
                sd[f"{prefix}bn.{k}"] = torch.from_numpy(arr.copy())
            else:
                if k == "kernel" and arr.shape[0] == 1:
                    arr = arr[0]
                sd[name] = torch.from_numpy(arr.copy())

    walk(params, "", False)
    walk(state, "", True)
    return sd


def phase_models(knn) -> dict:
    """Every model of the registry behind load_model, then the default
    configuration and the reference's .pth format through register():
    (a) all 47 entries at their published widths, a 3D forward over bench
        pair 0 (both clouds, 5 cm, out 32, conv1 = 7, all-ones input, bf16,
        BN folded as the pipeline folds it), each output finite and [N, 32],
        timed in one round over all entries (the median of 10 calls each,
        host clock between synchronisations, a warm-up first);
    (b) six representatives (one a structure) with non-trivial BN
        statistics: the card's f32 forward, BN folded, against the same net's
        f32 forward on the CPU with BN live, on a smaller pair, to
        MODELS_CARD_CPU_TOL;
    (c) register() from DeepGlobalRegistration(default_config()) (SimpleNetBN2C
        16-D, 6D ResUNetBN2C, 2.5 cm, f32, seeded random nets) on the four
        bench pairs: finite T, s/pair and the stage timers (poses are not
        held: the weights are random); then both kernels at this path's own
        shapes and data, as in the bench and KITTI phases: pair 0's 16-D
        feature match (nn1_mma) and its last ICP scan (nn1_scan), each held
        against the plain version and timed;
    (d) the bench weights written at run time as reference-schema .pth files
        (MinkowskiEngine names, state_dict_inlier None, and a second file
        with the seeded inlier tree written in): the nets built from them
        equal the .pkl-built nets bit for bit, and register() from the first
        holds the bench's gates on the four bench pairs.
    (c) and (d) are paths of their own: launch counts set to 0 just before
    and read just after."""
    import tempfile

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import (
        STAGES, DeepGlobalRegistration, build_net)
    from deepglobalregistration_tpu_torch.models import MODELS, load_model
    from deepglobalregistration_tpu_torch.ops import se3, sparse_grid
    from deepglobalregistration_tpu_torch.utils import checkpoint, device
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    pairs = [synthetic_pair(n=30000, seed=s) for s in range(4)]
    out = {}

    # (a) every registry entry at full width, bf16; one timing round over
    # all 47 in turn, each the median of 10 synchronised calls (the forwards
    # are launch-bound and the host clock jumps between calls).
    x0, x1 = (torch.as_tensor(x, device="cuda") for x in pairs[0][:2])
    grid = torch.cat([sparse_grid.voxelize(x0, 0.05, 0)[1],
                      sparse_grid.voxelize(x1, 0.05, 1)[1]])
    ones = torch.ones((grid.shape[0], 1), dtype=torch.bfloat16, device="cuda")
    plans, nets, fams = {}, {}, {}
    for name in MODELS:
        spec = load_model(name)
        cfg = spec.make_config(1, 32, conv1_kernel_size=7, normalize_feature=True, D=3)
        tree = spec.init_params(device.generator(0), cfg)
        nets[name] = (build_net(spec, tree, cfg, True, torch.bfloat16, "cuda"),
                      _plan(grid, 2, cfg, plans))
        fams.setdefault(_family(cfg), []).append(name)
    if len(nets) != 47:
        fail(f"models: the registry holds {len(nets)} entries, expected 47")
    ms = {}
    for name, (net, plan) in nets.items():
        ms[name], feats = _median_ms(lambda: net(plan, ones), 10)
        if feats.shape != (grid.shape[0], 32) or not bool(torch.isfinite(feats).all()):
            fail(f"models: {name} gave {tuple(feats.shape)} features, finite: "
                 f"{bool(torch.isfinite(feats).all())}")
    del nets
    per_family = {f: {"models": len(n), "ms_min": min(ms[m] for m in n),
                      "ms_max": max(ms[m] for m in n)} for f, n in fams.items()}
    print(json.dumps({"models_forward_ms": {
        "rows": int(grid.shape[0]), "dtype": "bf16",
        "per_model": ms, "per_family": per_family}}), flush=True)
    out["forward_ms"] = ms

    # (b) card against CPU, f32, non-trivial BN statistics.
    small = synthetic_pair(n=8000, seed=4)
    grid_c = torch.cat([sparse_grid.voxelize(torch.as_tensor(x), 0.05, b)[1]
                        for b, x in enumerate(small[:2])])
    ones_c = torch.ones((grid_c.shape[0], 1))
    plans_c, errs = {}, {}  # keyed by device too: one cache for both sides
    for i, name in enumerate(MODELS_CARD_CPU):
        spec = load_model(name)
        cfg = spec.make_config(1, 32, conv1_kernel_size=7, normalize_feature=True, D=3)
        params, state = spec.init_params(device.generator(10 + i), cfg)
        _nontrivial_norms(params, state, np.random.RandomState(i))
        card = build_net(spec, (params, state), cfg, True, torch.float32, "cuda")
        host = build_net(spec, (params, state), cfg, False, torch.float32, "cpu")
        got = card(_plan(grid_c.cuda(), 2, cfg, plans_c), ones_c.cuda()).cpu()
        want = host(_plan(grid_c, 2, cfg, plans_c), ones_c)
        errs[name] = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or errs[name] > MODELS_CARD_CPU_TOL:
            fail(f"models: {name} on the card (BN folded) against the CPU (BN "
                 f"live): max |diff| {errs[name]:.3e} (tolerance "
                 f"{MODELS_CARD_CPU_TOL})")
    print(json.dumps({"models_card_vs_cpu": {
        "rows": int(grid_c.shape[0]), "tolerance": MODELS_CARD_CPU_TOL,
        "max_abs_diff": errs}}), flush=True)
    out["card_vs_cpu"] = errs

    # (c) the default configuration, seeded random nets.
    dgr = DeepGlobalRegistration(default_config(), device="cuda")
    dgr.register(pairs[0][0], pairs[0][1])  # warm-up
    for t in dgr.stage_timers.values():
        t.reset()
    dgr.overflow_count = 0
    reset_counts(knn)
    t0 = time.time()
    Ts, branches = [], []
    for xyz0, xyz1, _ in pairs:
        Ts.append(dgr.register(xyz0, xyz1))
        branches.append(dgr.last_branch)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / len(pairs)
    launches = counts(knn)
    print(json.dumps({"default_config": {
        "feat_model": dgr.fcgf_cfg.name, "feat_dim": dgr.fcgf_cfg.out_channels,
        "inlier_model": dgr.inlier_cfg.name, "voxel_size": dgr.voxel_size,
        "voxel_bucket": dgr._cap, "sec_per_pair": dt,
        "stage_sec": {s: dgr.stage_timers[s].avg for s in STAGES},
        "branch_per_pair": branches, "overflow_pairs": dgr.overflow_count,
        "nn1_launches": launches,
        "informational_rre_deg": [pose_errors(T, p[2])[0] for T, p in zip(Ts, pairs)]}}),
        flush=True)
    if not all(T.shape == (4, 4) and np.isfinite(T).all() for T in Ts):
        fail("default_config(): non-finite or misshapen transform")
    if dgr.fcgf_cfg.name != "SimpleNetBN2C" or launches["nn1_mma"] < len(pairs):
        fail(f"default_config(): {dgr.fcgf_cfg.name}, nn1 launches {launches}")
    out["default_launches"] = launches
    # The kernels at this path's own shapes and data: pair 0's 16-D feature
    # match, and its last ICP scan (the source moved by the final pose).
    x0, x1 = dgr._as_tensor(pairs[0][0]), dgr._as_tensor(pairs[0][1])
    with torch.no_grad():
        sel0, sel1, _, _, a0, a1, _ = dgr.features(x0, x1)
    if a0.shape[1] != 16:
        fail(f"default_config(): {a0.shape[1]}-D features, expected 16")
    moved = se3.apply_transform(
        sel0, torch.as_tensor(Ts[0], dtype=torch.float32, device="cuda"))
    out["default_timings"] = [
        time_nn1(knn, a0, a1, "default_config() feature match (pair 0)"),
        time_nn1(knn, moved.contiguous(), sel1, "default_config() ICP scan (pair 0)",
                 bitwise=True)]

    # (d) the reference's .pth format.
    pkl = DeepGlobalRegistration(default_config(bf16=True, **BENCH), device="cuda")
    ckpt = checkpoint.load_checkpoint(WEIGHTS)
    net_cfg = {k: ckpt["config"][k] for k in (
        "voxel_size", "feat_model", "feat_model_n_out", "feat_conv1_kernel_size",
        "normalize_feature", "inlier_model", "inlier_conv1_kernel_size",
        "inlier_feature_type", "bn_momentum")}
    spec6 = load_model(net_cfg["inlier_model"])
    inlier_tree = spec6.init_params(device.generator(1), spec6.make_config(
        1, 1, conv1_kernel_size=net_cfg["inlier_conv1_kernel_size"], D=6))
    fcgf_sd = me_state_dict(ckpt["state_dict"]["params"], ckpt["state_dict"]["state"])
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for fname, inlier in (("fcgf_only.pth", None), ("with_inlier.pth", inlier_tree)):
            path = str(Path(d) / fname)
            torch.save({"epoch": 0, "state_dict": fcgf_sd,
                        "state_dict_inlier": None if inlier is None else
                        me_state_dict(*inlier),
                        "optimizer": None, "scheduler": None, "config": net_cfg,
                        "best_val": -1.0, "best_val_epoch": -1,
                        "best_val_metric": "succ_rate"}, path)
            paths.append(path)
        nets = [DeepGlobalRegistration(default_config(bf16=True, **dict(
            BENCH, weights=path)), device="cuda") for path in paths]
    same = {}
    for tag, other in zip(("fcgf_only", "with_inlier"), nets):
        for part in ("fcgf", "inlier"):
            a, b = getattr(pkl, part).state_dict(), getattr(other, part).state_dict()
            same[f"{tag}.{part}"] = a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
    trained = [n.inlier_trained for n in nets]
    dgr = nets[0]
    dgr.register(pairs[0][0], pairs[0][1])  # warm-up
    dgr.overflow_count = 0
    reset_counts(knn)
    errs = [pose_errors(dgr.register(xyz0, xyz1), T_gt) for xyz0, xyz1, T_gt in pairs]
    torch.cuda.synchronize()
    launches = counts(knn)
    rre = float(np.mean([e[0] for e in errs]))
    rte = float(np.mean([e[1] for e in errs]))
    print(json.dumps({"pth": {
        "state_dict_equal_to_pkl": same, "inlier_trained": trained,
        "rre_deg": rre, "rte_cm": rte * 100,
        "rre_deg_per_pair": [e[0] for e in errs],
        "rte_cm_per_pair": [e[1] * 100 for e in errs],
        "overflow_pairs": dgr.overflow_count, "nn1_launches": launches}}), flush=True)
    if not all(same.values()):
        fail(f".pth: nets differ from the .pkl-built ones: {same}")
    if trained != [False, True]:
        fail(f".pth: inlier_trained {trained}, expected [False, True]")
    if rre > RRE_DEG or rte > RTE_M or dgr.overflow_count:
        fail(f".pth: mean rre {rre:.3f} deg / rte {rte * 100:.2f} cm, "
             f"{dgr.overflow_count} overflow pairs (limits 1 deg / 10 cm / 0)")
    if launches["nn1_mma"] < len(pairs):
        fail(f".pth: nn1 launches {launches} for {len(pairs)} pairs")
    out["pth_launches"] = launches
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 2
    if not (ROOT / "deepglobalregistration_tpu_torch").is_dir():
        print("FAIL: the port's package is not beside chip_smoke.py", flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    from deepglobalregistration_tpu_torch.ops import knn
    from deepglobalregistration_tpu_torch.utils import cuda_build, device

    device.set_precision()
    t0 = time.time()
    cuda_build.build(verbose=True)  # prints ptxas registers / spills
    card = card_line()
    print(f"build: {time.time() - t0:.3f} s; card: {card}", flush=True)
    synth_err = phase_kernels(knn)
    gather_entries = phase_gather()
    e = phase_end_to_end(knn)
    cand_launches = phase_bench_candidates(knn, e["pairs"])
    staged = phase_staged(knn, e["pairs"][0])
    kitti = phase_kitti(knn)
    batch_err = phase_batch_kernels_random(knn)
    batch = phase_batch(knn)
    batch_kitti = phase_batch_kitti(knn)
    models = phase_models(knn)
    feat, scan = e["timings"]
    kfeat, kscan = kitti["timings"]
    dfeat, dscan = models["default_timings"]
    entries = []
    for name, bench_r, kitti_r, default_r, path in (
            ("nn1_scan", scan, kscan, dscan, "ICP scan"),
            ("nn1_mma", feat, kfeat, dfeat, "feature match")):
        entry = {"name": name, "route": "cuda",
                 "source": f"deepglobalregistration_tpu_torch/csrc/{name}.cu",
                 "replaces": "deepglobalregistration_tpu/ops/pallas_knn.py:33",
                 "launches": e["launches"][name],
                 "max_abs_err": max(synth_err[name], bench_r["max_abs_err"],
                                    kitti_r["max_abs_err"], default_r["max_abs_err"]),
                 "shape": f"bench {path} {bench_r['shape']}; *_kitti: KITTI "
                          f"{path} {kitti_r['shape']}; *_default: default_config() "
                          f"{path} {default_r['shape']}"}
        for suffix, r in (("", bench_r), ("_kitti", kitti_r), ("_default", default_r)):
            keys = ["ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "near_ties", "max_err_of_tolerance"]
            if name == "nn1_mma":
                keys.append("bound_f32_ms")
            entry.update({f"{k}{suffix}": r[k] for k in keys})
        entry.update({f"launches_{k}": v[name] for k, v in (
            ("kitti", kitti["launches"]), ("bench_icp_candidates", cand_launches),
            ("staged", staged["staged"]), ("knn_cpu", staged["knn_cpu"]),
            ("default_config", models["default_launches"]),
            ("pth", models["pth_launches"]))})
        entries.append(entry)
    entries[1]["bound_note"] = ("bound_ms: 3 x 2 N0 N1 C TF32 operations at 495 "
                                "TFLOP/s; bound_f32_ms: N0 N1 (2C + 3) at 67 TFLOP/s")
    for name, path in (("nn1_scan_batched", "ICP scan"),
                       ("nn1_mma_batched", "feature match")):
        r = batch["timings"][name]
        entry = {"name": name, "route": "cuda",
                 "source": "deepglobalregistration_tpu_torch/csrc/"
                           f"{name.replace('_batched', '')}.cu",
                 "replaces": "deepglobalregistration_tpu/ops/pallas_knn.py:33",
                 "launches": batch["launches"][name],
                 "max_abs_err": max(batch_err[name], batch["max_abs_err"][name]),
                 "shape": f"register_batch bench {path} (the TPU kernel under "
                          f"vmap): {r['shape']}",
                 **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "unbatched_sum_ms")},
                 "launches_kitti": batch_kitti["launches"][name]}
        if name == "nn1_mma_batched":
            k = batch_kitti["timing"]
            entry.update({f"{key}_kitti": k[key] for key in (
                "ms", "unbatched_sum_ms", "plain_ms", "library_ms", "bound_ms")})
        entries.append(entry)
    print(json.dumps({"kernels": entries + gather_entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
