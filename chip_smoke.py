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
     then the stage breakdown (with the slot lists' share of the plan
     builds), the slot-sum kernels (``phase_slot_sum``: ``slot_sum``,
     ``slot_sum_runs`` and ``slot_sum_rows`` from ``csrc/slot_sum.cu`` bit
     for bit their plain versions given the same products, on the bench
     FCGF level-0, stride-2 down and transposed up maps, the bench 6D
     level-0 and level-3 maps and a KITTI-scale level-0 map, forward and
     dx by row, dk by runs, the forward and dk also split in two launches;
     sum pooling on the SP families' plan; each timed warm and L2-cold
     beside its bound and ``index_add_`` in default and deterministic
     mode; the conv module's bits under a cut chunk size and on a repeat
     call; the instance norm on an IN-family plan, two calls alike and
     within 1e-5 of f64), the RANSAC branch, the bf16 forward against the
     f32 one, and the card against the CPU's plain path on a small pair;
     ``slot_sum`` must have launched on every register() of the path;
  5. the bench pairs again with ``icp_candidates="on"`` (candidate-list ICP
     and its checked fallback), held to the same pose limits;
  6. the staged API on bench pair 0 (``preprocess`` through
     ``safeguard_registration`` with the feature-matching safeguard, then
     the ICP polish), then ``register()`` with ``knn_search_method="cpu"``,
     both held to the bench's pose limits;
  7. ``register()`` at the KITTI-scale configuration (``lidar_like_pair``,
     120k points, 0.3 m voxel, conv1=5, dense extent 384x384x48, bf16,
     seeded random weights): a warm-up pair and pairs 0..2, each of which
     must take candidate-list ICP; register() twice more on pair 0, bit for
     bit alike (T, branch, iterations, launches); the icp stage again with
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
     the bound); ``bench.py``'s 8-pair stream in turns (batch, many,
     loop, loop, many, batch) through ``register_batch`` (two sub-batches),
     ``register_many`` (the window: 3 pairs on worker threads, each on its
     own CUDA stream) and the ``register()`` loop, with each turn's peak
     memory: the second loop turn and every window turn bit for bit the
     first loop turn (T, each record's branch and iterations, the
     launches); every window and loop turn's 1-NN launches exactly those its
     pairs' records report, the window at the bench's pose limits with the
     loop's gate branch and ICP mode on every pair, the batch's gate bits,
     ``cand_ok`` and reruns the loop's and each batch pose within
     ``BATCH_LOOP_DEG`` / ``BATCH_LOOP_M`` of the loop's; one profiled call
     of each form (the busy share counts overlapping kernels once); then a
     child process under ``torch.use_deterministic_algorithms``
     (``--deterministic-stream``), which holds ``register_many`` bit for
     bit against two loops (or, where it names an op without a
     deterministic implementation, within the loops' own gap) and gives
     what deterministic mode costs ``register()``;
 10. ``register_batch`` on the three KITTI-scale pairs (the 65536 bucket, so
     candidate-list ICP without the checked wrapper): finite poses, a rerun
     for exactly the pairs whose gate bit or ``cand_ok`` is false, the time
     of the batched program apart from the reruns;
 11. the models: every entry of ``models.load_model``'s registry (47) at
     its published widths, a bf16 forward over bench pair 0, finite and
     timed, launching ``slot_sum`` and ``slot_sum_rows``; six
     representatives (SimpleNetBN2C, SimpleNetIN2, ResUNetBN2Cv2,
     ResUNetBN2SPC, ResUNetINBNSPC, PyramidNet6INBN) with non-trivial BN
     statistics, the card's f32 forward (BN folded) against
     the CPU's (BN live); ``register()`` from ``default_config()``
     (SimpleNetBN2C, 2.5 cm, random nets) on the four bench pairs; the
     bench weights written as reference-schema ``.pth`` files, whose nets
     must equal the ``.pkl``-built ones bit for bit, and ``register()`` from
     the ``.pth`` held to the bench's pose limits;
 12. the evaluation entry points: ``demo.main([])`` (bundled weights, held
     to success and the bench's pose limits); the 3DMatch script's
     ``evaluate`` over the four bench pairs written as PLY fragments with a
     gt.log (recall 1, the bench's pose limits, the npz); the KITTI
     script's loader with two workers over a KITTI-layout drive of
     120k-point scans, whose ground-truth ICP runs on the card in this
     process first (within 0.1 deg / 1 cm of the fixture's exact poses;
     its last scan bit for bit the plain version's, and timed), then
     ``evaluate`` at the KITTI-scale configuration;
 13. training at the bench configuration, full width, batch 4
     (``phase_train``): 8 steps on one batch (finite, falling loss), one
     step holding ``nn1_mma_batched`` to one launch and to its plain
     version and printing its slot-sum launches (``slot_sum_runs``, the
     convs' dk, and ``slot_sum`` must have launched), the step's stage
     split, s/step, peak memory (with and without ``--remat``) and busy
     share with the slot-sum kernels' device ms, one step on the card
     against the CPU, ``train.main`` with validation, resume and the
     checkpoint as ``DeepGlobalRegistration``'s weights, and 4 FCGF
     hardest-contrastive steps; one step twice from the same state: every
     conv backward's dx and dk bit for bit on its own inputs, each leaf's
     gap printed;
 14. data parallelism (``phase_parallel``, ``parallel/data_parallel.py``):
     the train step on 2 ranks sharing ``cuda:0`` through gloo against the
     one-process step on bench batch 4 (loss 1e-5 relative; gradients and
     updated parameters 1e-4 of the largest leaf's; the ranks bit for bit
     after 3 steps; one ``nn1_mma_batched`` launch a rank a step, its
     indices those of the kernel on the rank's shard features, held to the
     plain version at the shard's shapes; s/step and each rank's peak
     memory); ``register_batch(mesh=...)`` on the
     8-pair bench stream over the 2 ranks against the one-process batch
     (equal gate / ``cand_ok`` / rerun bits, the bench pose limits, s/pair
     in turns); ``make_mesh(2)`` and ``train.main --num_devices 2`` raise
     with one card, NCCL on one shared card raises; with 2 or more cards
     the NCCL dry runs;
 15. the tail (``phase_tail``): (a) ``tools/synthetic_e2e.main(["--quick"])``
     (room profile, full-width nets: FCGF self-training, inlier-net
     training with validation, the 3DMatch-style benchmark): finite stage-A
     losses, every checkpoint, the stats npz (1, 2, 5), every key of the JAX
     tool's summary, the 1-NN launches of each stage; then the hit probe's
     ``nn1_mma_batched`` launch held to its unbatched launches and the plain
     version, and timed; (b) the TSDF tool (``utils/integration.py``) on a
     seeded 10-frame 640 x 480 depth sequence of a box room: the CLI and
     the volume at the default 1 cm over 6 x 6 x 4 m (ms a frame, peak
     memory, points), and on a 2 cm cut over 2 x 2 x 2 m the card's volumes
     against the port's CPU run (1e-6, equal point sets); (c)
     ``utils/profiling.trace`` around one bench register(): the kernel table
     must name both 1-NN kernels and the line join must put time on lines
     of the port; (d) ``export_bench_weights`` on stage A's checkpoint,
     loaded by ``DeepGlobalRegistration``; ``golden_fcgf`` on the committed
     weights against their own identity-order features (only "identity"
     passes); ``ransac_sweep`` at two trials a budget;
 16. print one JSON line describing every kernel, the card's line, and as
     the last line ``{"ok": true, "device": {...}}``.

Each path (4-7, 9, 10, 11's default configuration and .pth runs, 12's
demo, 3DMatch loop, KITTI ground truth and KITTI loop, 13's train step and
``train.main``, 14's data-parallel step and fan-out, counted in each
rank's process, 15's chain) is driven with the kernels' launch counts set
to 0 just before it and read just after; launches made to compare a kernel
with its plain version are not counted. Imports nothing of JAX. Exits
non-zero when no CUDA device is visible.

``python3 chip_smoke.py --chain [--keep DIR] [synthetic_e2e flags]`` runs instead the
chain at full size (``chain_full``): the chain, each stage's 1-NN launch
timed at its own shapes, and with ``--profile lidar`` the KITTI-scale pairs
from the trained checkpoint: their feature match held to ``check_nn1``
without the random features' near-tie allowance, and register()'s ICP
stage with ``icp_candidates`` "auto" and "off" in turns; results go to
``<keep>/e2e_<profile>/`` (``--keep DIR``, default ``outputs``, relative to
the checkout). ``--deterministic-stream`` is phase 9's child.
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
              bitwise: bool = False, dense_ties: bool = True) -> dict:
    """The width's kernel against the plain version on one input; returns
    the comparison's numbers. ``exact``: indices equal on every row (exact
    duplicates); ``bitwise``: indices and d2 equal bit for bit (kernel A on
    the main path's ICP scans); ``dense_ties`` False: no allowance past
    NEAR_TIE_SHARE (trained features)."""
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
        if (not mma or not dense_ties
                or r["kernel_misses_f64_argmin"] > r["plain_misses_f64_argmin"]):
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
    r["library_ms"] = _library_nn1_ms(F0, F1)
    r["bound_ms"], r["bound_by"] = nn1_bound_ms(n0, n1, c, tensor_cores=mma)
    bounds = f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}"
    if mma:
        r["bound_f32_ms"], _ = nn1_bound_ms(n0, n1, c)
        bounds += f", tensor cores; f32 non-tensor {r['bound_f32_ms']:.4f} ms"
    r["shape"] = f"{n0}x{n1} C={c}"
    print(f"nn1 {label} {r['shape']} ({kernel.__name__}): kernel {r['ms']:.4f} ms "
          f"(eager {r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"torch.cdist+argmin {r['library_ms']} ms, {bounds})", flush=True)
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
    reset_slot_counts()


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


def _pair_plans(dgr, pair) -> dict:
    """The FCGF plan of a pair's two clouds and the 6D plan of its 1-NN
    correspondences, as register() builds them, with each build's and each
    net's host ms (between synchronisations)."""
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
    return {"grid": grid, "plan3": plan3, "plan6": plan6,
            "fcgf_plan_ms": ms_plan3, "fcgf_net_ms": ms_net3,
            "inlier_plan_ms": ms_plan6, "inlier_net_ms": ms_net6}


def breakdown(dgr, pair, sec_per_pair: float, label: str = "bench") -> dict:
    """Plan builds (with the slot lists' share) against network compute, and
    the device's busy share of one register() call (torch.profiler's CUDA
    kernel time over wall time); returns the pair's plans."""
    p = _pair_plans(dgr, pair)
    plan3, plan6 = p["plan3"], p["plan6"]
    edges3 = sum(em.n_edges for em in plan3.selfs + plan3.downs + plan3.ups)
    edges6 = sum(em.n_edges for em in plan6.selfs + plan6.downs + plan6.ups)
    print(json.dumps({
        "config": label,
        "rows_3d": [int(g.shape[0]) for g in plan3.grids],
        "rows_6d": [int(g.shape[0]) for g in plan6.grids],
        "edges_3d_k3_maps": edges3, "edges_6d_k3_maps": edges6,
        **{k: p[k] for k in ("fcgf_plan_ms", "fcgf_net_ms", "inlier_plan_ms",
                             "inlier_net_ms")},
        "fcgf_slot_lists_ms": slot_lists_ms(plan3),
        "inlier_slot_lists_ms": slot_lists_ms(plan6)}), flush=True)

    busy = profile_busy(lambda: dgr.register(pair[0], pair[1]), sec_per_pair)
    if busy is not None:
        print(json.dumps({"config": label, **busy}), flush=True)
    return p


def profile_busy(fn, unprofiled_s: float, by_name: str | None = None) -> dict | None:
    """One fn() under ``utils/profiling.trace`` (torch.profiler, no Python
    stacks): its wall time, the CUDA kernels' busy time and launches, the
    top ten kernels, and the busy share over the profiled wall time and over
    ``unprofiled_s`` (the same work's time without the profiler); with
    ``by_name``, every kernel whose name holds it, ms summed by name, and
    their share of the kernel time. None when the trace holds no kernel
    time."""
    import tempfile

    from deepglobalregistration_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp, with_stack=False):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_ms, launches = profiling.kernel_totals(tmp)
        busy_ms = profiling.kernel_busy_ms(tmp)
        top = profiling.summarize_trace(tmp, top=10)
        named = ({k: v for k, v in profiling.summarize_trace(tmp, top=10 ** 6).items()
                  if by_name in k} if by_name else {})
    if dev_ms <= 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return None
    # Busy: the time in which at least one kernel ran (kernels on several
    # streams overlap); kernel_ms: the kernels' times summed.
    r = {} if not by_name else {
        "named": by_name, "named_kernels_ms": named,
        "named_kernel_ms": sum(named.values()),
        "named_share_of_kernel_ms": sum(named.values()) / dev_ms}
    return {**r, "profiled_wall_ms": wall * 1e3, "device_kernel_ms": dev_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share_profiled": busy_ms / (wall * 1e3),
            "device_busy_share_unprofiled": busy_ms / (unprofiled_s * 1e3),
            "device_kernel_launches": launches,
            "top_kernels_ms": {k[:70]: v for k, v in top.items()}}


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
    slot_launches = slot_counts()
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
        "nn1_launches": launches, "slot_sum_launches": slot_launches,
        "slot_sum_launches_per_register": slot_launches["slot_sum"] / len(pairs),
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
    if slot_launches["slot_sum"] < len(pairs):
        fail(f"slot_sum launches {slot_launches} for {len(pairs)} pairs: the "
             "convs did not sum through the kernel")

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

    slot = phase_slot_sum(breakdown(dgr, pairs[0], dt))
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
    return {"launches": launches, "timings": timings, "pairs": pairs, "Ts": Ts,
            "slot_launches": slot_launches, "slot": slot}


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


def reset_slot_counts() -> None:
    from deepglobalregistration_tpu_torch.ops import slot_sum as ss

    ss.slot_sum_cuda.launches = ss.slot_sum_rows_cuda.launches = 0
    ss.slot_sum_runs_cuda.launches = 0


def slot_counts() -> dict:
    from deepglobalregistration_tpu_torch.ops import slot_sum as ss

    return {"slot_sum": ss.slot_sum_cuda.launches,
            "slot_sum_rows": ss.slot_sum_rows_cuda.launches,
            "slot_sum_runs": ss.slot_sum_runs_cuda.launches}


def slot_sum_bound_ms(src_bytes: int, rows: int, c: int, n_slots: int, adds: int):
    """(ms, by): the larger of the bytes' time (the sources read once: the
    real slots' products, or the rows pooling reads; out [rows, c] f32 read
    and written once; the slot lists, n_slots int32 slots (0 for runs) and
    rows + 1 pointers, read once) at 3.35 TB/s and the adds' at 67
    TFLOP/s."""
    t_bytes = (src_bytes + 8 * rows * c + 4 * (n_slots + rows + 1)) / PEAK_BYTES
    t_ops = adds / PEAK_F32_FLOPS
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _hold_slot_case(label: str, kernel, plain, out0, library, bound) -> dict:
    """The kernel against its plain version on the same inputs, bit for bit,
    then its time (CUDA graph replays of 50 calls; eager: back-to-back
    calls; cold: one call after a 64 MB write, the L2 cold), the plain
    version's, and the library call's (``index_add_``) in default and in
    deterministic mode."""
    from deepglobalregistration_tpu_torch.tools.gather_bench import time_ms
    from deepglobalregistration_tpu_torch.tools.slot_sum_bench import cold_ms

    got, want = kernel(out0.clone()), plain(out0.clone())
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"slot_sum {label}: the kernel and the plain version differ on "
             f"{int((got != want).sum())} of {got.numel()} values (max "
             f"{float((got - want).abs().max()):.3e})")
    out = out0.clone()
    r = {"case": label, "rows": int(out0.shape[0]), "c": int(out0.shape[1]),
         "ms": time_ms(lambda: kernel(out)), "eager_ms": cuda_ms(lambda: kernel(out)),
         "cold_ms": cold_ms(lambda: kernel(out)),
         "plain_ms": cuda_ms(lambda: plain(out), 2), "library_ms": cuda_ms(library)}
    torch.use_deterministic_algorithms(True)
    try:
        r["library_deterministic_ms"] = cuda_ms(library, 5)
    finally:
        torch.use_deterministic_algorithms(False)
    r["bound_ms"], r["bound_by"] = bound
    r["max_abs_err"] = 0.0
    print(f"slot_sum {label}: kernel {r['ms']:.4f} ms (eager {r['eager_ms']:.4f}, "
          f"L2-cold {r['cold_ms']:.4f}), plain {r['plain_ms']:.4f} ms, index_add_ "
          f"{r['library_ms']:.4f} ms (deterministic {r['library_deterministic_ms']:.4f}), "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); bit for bit the plain "
          "version", flush=True)
    return r


def _hold_slot_split(c: dict) -> dict:
    """A conv map's sum in two launches equals one, bit for bit: the
    forward split at a tile in the middle of the map, dk (runs) at a tile
    in the middle of the longest run. Returns where it was split."""
    from deepglobalregistration_tpu_torch.ops import slot_sum as ss
    from deepglobalregistration_tpu_torch.ops.edge_conv import TILE

    P, ptr = c["P"], c["ptr"]
    whole = c["kernel"](c["out0"].clone())
    split = c["out0"].clone()
    if c["slots"] is None:
        runs = ptr[1:] - ptr[:-1]
        j = int(runs.argmax())
        cut = int(ptr[j]) + max(1, int(runs[j]) // 2)
        ss.slot_sum_runs_cuda(split, P[:cut], 0, ptr)
        ss.slot_sum_runs_cuda(split, P[cut:], cut, ptr)
        where = f"tile {cut}, in offset {j}'s run of {int(runs[j])}"
    else:
        cut = P.shape[0] // (2 * TILE) * TILE  # a tile boundary in the middle
        ss.slot_sum_cuda(split, P[:cut], 0, ptr, c["slots"])
        ss.slot_sum_cuda(split, P[cut:], cut, ptr, c["slots"])
        where = f"slot {cut}"
    torch.cuda.synchronize()
    if not torch.equal(whole, split):
        fail(f"slot_sum {c['case']}: two launches split at {where} differ from one")
    return {"split_at": where}


def slot_lists_ms(plan) -> float:
    """Host ms (between synchronisations) of building every map's slot
    lists again, both directions: the part of the plan build they add."""
    from deepglobalregistration_tpu_torch.ops import edge_conv

    maps = [m for m in plan.selfs + plan.downs + plan.ups + plan.pool_downs
            + plan.pool_ups + [plan.conv1] if m is not None]
    ms, _ = _host_ms(lambda: [(edge_conv.row_slots(m.tile_out, m.n_out, m.n_edges),
                               edge_conv.row_slots(m.tile_in, m.n_in, m.n_edges))
                              for m in maps])
    return ms


def phase_slot_sum(plans) -> dict:
    """The slot-sum kernels (``csrc/slot_sum.cu``) against their plain
    versions, bit for bit, on the same inputs at the main path's maps and
    widths, each timed beside its bound and ``index_add_`` (default and
    deterministic):
    - ``slot_sum`` (forward, dx) and ``slot_sum_runs`` (dk): the bench FCGF
      plan of pair 0 (ResUNetBN2C widths: the level-0 same-stride map at 32
      -> 32, the stride-2 down map at 32 -> 64, the transposed up map at 128
      -> 64), the bench 6D inlier net's level-0 map (32 -> 32), a
      KITTI-scale level-0 map (lidar_like_pair seed 0, 0.3 m, 32 -> 32)
      and the 6D level-3 map at the inlier net's widest convs (256 -> 256)
      (``tools/slot_sum_bench.slot_maps``), each also timed L2-cold; the
      forward also split in two chunks, dk in the middle of its longest
      run;
    - ``slot_sum_rows``: sum pooling on the SP families' plan of pair 0
      (level 0 -> 1 at C = 32, its transpose at C = 64), forward and dx;
    - the module path: ``sparse_conv`` forward and both gradients on the
      level-0 map with ``_MAX_CHUNK_ELEMS`` cut to 7 tiles a chunk, bit for
      bit the one-chunk call, and two calls bit for bit alike;
    - the instance norm on an IN-family plan's level 0 (the bench grid, two
      clouds, C = 32), forward and gradient: two calls bit for bit alike,
      and within 1e-5 of the f64 CPU result."""
    from deepglobalregistration_tpu_torch.ops import sparse_conv as sc
    from deepglobalregistration_tpu_torch.tools.slot_sum_bench import slot_cases

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    plan3 = plans["plan3"]
    cases, rows_cases = [], []
    for c in slot_cases(plans, g):
        r = _hold_slot_case(c["case"], c["kernel"], c["plain"], c["out0"], c["library"],
                            slot_sum_bound_ms(*c["bound"]))
        r.update(map=c["map"], kind=c["kind"], slots=c["bound"][3])
        if c["pool"]:
            rows_cases.append(r)
            continue
        if c["kind"] in ("forward", "dk"):
            r.update(_hold_slot_split(c))
        cases.append(r)

    # The module path: chunking and repeat calls change no bit.
    em = plan3.selfs[0]
    x = torch.randn(em.n_in, 32, device="cuda", generator=g).bfloat16()
    w = torch.randn(27, 32, 32, device="cuda", generator=g) / 30
    dy = torch.randn(em.n_out, 32, device="cuda", generator=g).bfloat16()

    def conv_grads():
        xr, wr = x.float().requires_grad_(True), w.clone().requires_grad_(True)
        y = sc.sparse_conv(xr.bfloat16(), wr, em)
        return (y,) + torch.autograd.grad(y, (xr, wr), dy)

    one = conv_grads()
    again = conv_grads()
    cut = sc._MAX_CHUNK_ELEMS
    sc._MAX_CHUNK_ELEMS = 32 * (em.tile + 32) * 7
    try:
        chunked = conv_grads()
    finally:
        sc._MAX_CHUNK_ELEMS = cut
    for name, a, b, c in zip(("y", "dx", "dk"), one, again, chunked):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            fail(f"sparse_conv {name}: repeat or 7-tile chunks differ from one call")

    # The instance norm on an IN-family plan's level 0.
    batch, clouds = plan3.seg(0)
    xi = torch.randn(batch.shape[0], 32, device="cuda", generator=g) * 3 + 1
    gi = torch.randn_like(xi)

    def norm(xin):
        xr = xin.clone().requires_grad_(True)
        y = sc.instance_norm(xr, batch.to(xin.device), clouds)
        return y, torch.autograd.grad(y, xr, gi.to(xin.device, xin.dtype))[0]

    n1, n2 = norm(xi), norm(xi)
    ref = norm(xi.double().cpu())
    if not all(torch.equal(a, b) for a, b in zip(n1, n2)):
        fail("instance_norm: two calls on the card differ")
    norm_gap = max(_rel_gap(a, b) for a, b in zip(n1, ref))
    if norm_gap > 1e-5:
        fail(f"instance_norm: the card is {norm_gap:.3e} off the f64 CPU result")
    norm_ms = cuda_ms(lambda: norm(xi))
    r = {"cases": cases, "rows_cases": rows_cases,
         "instance_norm": {"rows": int(batch.shape[0]), "c": 32,
                           "f64_cpu_gap": norm_gap, "fwd_bwd_ms": norm_ms}}
    print(json.dumps({"slot_sum_phase": {"cases": cases + rows_cases,
                                         "instance_norm": r["instance_norm"]}}),
          flush=True)
    return r


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
    # The same call twice on pair 0, default mode: the same bits (T, branch,
    # iterations, launches).
    rep = []
    for _ in range(2):
        reset_counts(knn)
        T = dgr.register(pairs[0][0], pairs[0][1])
        torch.cuda.synchronize()
        rep.append((T, dgr.last_branch, dict(dgr.last_iterations), counts(knn),
                    slot_counts()))
    same = np.array_equal(rep[0][0], rep[1][0]) and rep[0][1:] == rep[1][1:]
    print(json.dumps({"kitti_repeat_pair0": {
        "same_bits": bool(same), "max_abs_T_gap": float(np.abs(rep[0][0] - rep[1][0]).max()),
        "iterations": [r[2] for r in rep], "nn1_launches": [r[3] for r in rep],
        "slot_sum_launches": [r[4] for r in rep]}}), flush=True)
    if not same:
        fail("KITTI scale: two register() calls on pair 0 differ in default mode")
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

    # bench.py's stream: the four pairs twice, in turns: the batched program
    # (two sub-batches), the register_many window (3 pairs on worker
    # streams) and the register() loop.
    stream = [pairs[i % 4] for i in range(8)]
    sx, sy = [p[0] for p in stream], [p[1] for p in stream]
    cmp = batch_bench.compare(dgr, sx, sy)
    stream_r = hold_stream(cmp["turns"], stream)
    loop_s = cmp["mean_s_per_pair"]["loop"]
    busy = {"batch_4": profile_busy(
                lambda: dgr.register_batch(x0s, x1s, force_vmapped=True),
                4 * r4["s_per_pair"]),
            "register_many_8": profile_busy(lambda: dgr.register_many(sx, sy),
                                            8 * cmp["mean_s_per_pair"]["many"]),
            "loop_8": profile_busy(lambda: [dgr.register(a, b) for a, b in zip(sx, sy)],
                                   8 * loop_s)}
    print(json.dumps({"batch_stream_8": {
        "turns": [batch_bench.printable(t) for t in cmp["turns"]],
        "mean_s_per_pair": cmp["mean_s_per_pair"], **stream_r, "profiled": busy}}),
        flush=True)
    loop_turns = [t for t in cmp["turns"] if t["kind"] == "loop"]
    stream_deterministic_child({"s_per_pair": loop_s, "stage_s": {
        k: float(np.mean([t["register_stage_s"][k] for t in loop_turns])) / 8
        for k in loop_turns[0]["register_stage_s"]}})
    return {"launches": r4["launches"], "max_abs_err": err, "timings": timings,
            "s_per_pair": cmp["mean_s_per_pair"], "launches_many": stream_r["launches_many"]}


# register_batch against the register() loop on the 8-pair stream, each
# pair's pose: the batched program's own ops (batched refinement and ICP)
# move pair 1 by 0.004565 deg and 89.1 um, the same bits in default and in
# deterministic mode and in two runs (NVIDIA H100 80GB HBM3, 700 W). The
# bound is about twice that. (With the atomic index_add_ the convs once
# summed through, default mode needed 0.505 deg / 8.01 cm.)
BATCH_LOOP_DEG, BATCH_LOOP_M = 0.01, 0.0002


def _want_launches(records) -> dict:
    """The 1-NN launches that pairs' records imply: one feature match
    (``nn1_mma``) a pair, and one full scan (``nn1_scan``) an ICP evaluation
    (its iterations and the init's) of each pair whose full scan ran."""
    scan = sum(r.iterations["icp"] + 1 for r in records
               if r.iterations.get("icp_mode") == "full" or r.cand_fallback)
    return {"nn1_scan": scan, "nn1_mma": len(records), "total": scan + len(records),
            "nn1_scan_batched": 0, "nn1_mma_batched": 0}


def _pose_gaps(Ta, Tb):
    """Each pair's (rotation angle in deg, translation distance in m) between
    two poses; the angle from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), which
    resolves angles near 0 where the trace's arccos does not."""
    out = []
    for a, b in zip(Ta, Tb):
        f = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2 * np.sqrt(2))
        out.append((float(np.degrees(2 * np.arcsin(min(f, 1.0)))),
                    float(np.linalg.norm(a[:3, 3] - b[:3, 3]))))
    return out


def hold_stream(turns, stream) -> dict:
    """The 8-pair stream's turns: the second loop turn and every
    register_many turn bit for bit the first loop turn (T, each record's
    branch and iterations, the launches); each register_many and loop
    turn's launch counts exactly its records' (no launch lost under the
    threads), every register_many turn at the bench's pose limits with 0
    overflow pairs; each batch turn's gate bits, cand_ok and reruns the
    loop's, and each pose within BATCH_LOOP_DEG / BATCH_LOOP_M of the
    loop's."""
    loops = [t for t in turns if t["kind"] == "loop"]
    ref = loops[0]["records"]
    spread = _pose_gaps(loops[0]["T"], loops[-1]["T"])
    out = {"launches_many": None, "batch_vs_loop_deg": [], "batch_vs_loop_m": [],
           "loop_vs_loop_deg": max(g[0] for g in spread),
           "loop_vs_loop_m": max(g[1] for g in spread)}
    key = lambda t: [(r.branch, r.iterations) for r in t["records"]]
    # Default mode, fixed-order convs: the same call gives the same bits.
    for t in loops[1:] + [t for t in turns if t["kind"] == "many"]:
        gaps = _pose_gaps(t["T"], loops[0]["T"])
        if not (np.array_equal(t["T"], loops[0]["T"]) and key(t) == key(loops[0])
                and t["launches"] == loops[0]["launches"]):
            fail(f"stream {t['kind']} turn differs from the first loop turn in "
                 f"default mode: max {max(g[0] for g in gaps):.3e} deg / "
                 f"{max(g[1] for g in gaps):.3e} m, records equal "
                 f"{key(t) == key(loops[0])}, launches {t['launches']} against "
                 f"{loops[0]['launches']}")
    for t in turns:
        label = f"stream {t['kind']} turn"
        if t["kind"] == "batch":
            _check_batch_launches(t, "register_batch (bench stream, 8 pairs)")
            lb = t["last_batch"]
            gate = [r.branch == "refine" for r in ref]
            cand = [not r.cand_fallback for r in ref]
            if (lb["gate"] != gate or lb["cand_ok"] != cand
                    or lb["rerun"] != [not (g and c) for g, c in zip(gate, cand)]):
                fail(f"{label}: gate {lb['gate']}, cand_ok {lb['cand_ok']}, rerun "
                     f"{lb['rerun']} against the loop's gate {gate}, cand_ok {cand}")
            gaps = _pose_gaps(t["T"], loops[0]["T"])
            out["batch_vs_loop_deg"].append(max(g[0] for g in gaps))
            out["batch_vs_loop_m"].append(max(g[1] for g in gaps))
            if (out["batch_vs_loop_deg"][-1] > BATCH_LOOP_DEG
                    or out["batch_vs_loop_m"][-1] > BATCH_LOOP_M):
                fail(f"{label}: a pose {out['batch_vs_loop_deg'][-1]:.4f} deg / "
                     f"{out['batch_vs_loop_m'][-1] * 100:.3f} cm off the loop's "
                     f"(bound {BATCH_LOOP_DEG} deg / {BATCH_LOOP_M * 100} cm)")
            continue
        recs = t["records"]
        want = _want_launches(recs)
        if t["launches"] != {k: want[k] for k in t["launches"]}:
            fail(f"{label}: launches {t['launches']}, the records want {want}")
        if t["kind"] != "many":
            continue
        out["launches_many"] = out["launches_many"] or dict(t["launches"])
        errs = [pose_errors(T, p[2]) for T, p in zip(t["T"], stream)]
        rre = float(np.mean([e[0] for e in errs]))
        rte = float(np.mean([e[1] for e in errs]))
        if rre > RRE_DEG or rte > RTE_M or any(r.overflow for r in recs):
            fail(f"{label}: mean rre {rre:.3f} deg / rte {rte * 100:.2f} cm, "
                 f"{sum(r.overflow for r in recs)} overflow pairs (limits 1 deg / "
                 "10 cm / 0)")
        if ([(r.branch, r.iterations.get("icp_mode")) for r in recs]
                != [(r.branch, r.iterations.get("icp_mode")) for r in ref]):
            fail(f"{label}: branches and ICP modes differ from the loop's")
        out.setdefault("many_rre_deg", []).append(rre)
        out.setdefault("many_rte_cm", []).append(rte * 100)
    return out


def stream_deterministic_child(default_loop: dict) -> dict:
    """``python3 chip_smoke.py --deterministic-stream`` in a child process
    (CUBLAS_WORKSPACE_CONFIG=:4096:8, deterministic algorithms), which holds
    register_many bit for bit against the loop; returns its JSON line with
    its loop's s/pair and stage split beside ``default_loop``'s (this
    process's loop turns: ``s_per_pair``, ``stage_s`` a pair)."""
    import os

    t0 = time.time()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--deterministic-stream"], env=env, capture_output=True,
                          text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
        fail(f"the deterministic stream check exited {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith('{"deterministic_stream"'))
    r = json.loads(line)["deterministic_stream"]
    r["child_s"] = time.time() - t0
    r["default_loop_s_per_pair"] = default_loop["s_per_pair"]
    r["deterministic_cost"] = r["loop_s_per_pair"] / default_loop["s_per_pair"]
    r["default_loop_stage_s"] = default_loop["stage_s"]
    print(json.dumps({"deterministic_stream_cost": {
        k: r[k] for k in ("loop_s_per_pair", "default_loop_s_per_pair",
                          "deterministic_cost", "loop_stage_s", "default_loop_stage_s",
                          "child_s")}}), flush=True)
    return r


def deterministic_stream() -> int:
    """The child of ``stream_deterministic_child``: bench.py's 8-pair stream
    through the register() loop twice, register_many (window 3) and
    register_batch once, under ``torch.use_deterministic_algorithms``. With
    no op reported as nondeterministic, the loops and register_many must
    agree bit for bit (T, each record's branch, iterations and ICP mode,
    launch counts); else, with the ops named, each pair's branch and ICP
    mode and a finite pose within the loops' own gap plus 1 mm and 0.05 deg.
    Prints the batch's gap against the loop."""
    import warnings

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.ops import knn
    from deepglobalregistration_tpu_torch.tools import batch_bench
    from deepglobalregistration_tpu_torch.utils import cuda_build, device
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    device.set_precision()
    cuda_build.build()
    torch.use_deterministic_algorithms(True, warn_only=True)
    dgr = DeepGlobalRegistration(default_config(bf16=True, **BENCH), device="cuda")
    pairs = [synthetic_pair(n=30000, seed=s) for s in range(4)]
    stream = [pairs[i % 4] for i in range(8)]
    sx, sy = [p[0] for p in stream], [p[1] for p in stream]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        turns = {}  # loop_1 is also the warm-up: loop_2 gives the time
        for name, kind in (("loop_1", "loop"), ("loop_2", "loop"), ("many", "many"),
                           ("batch", "batch")):
            dgr._seeds.manual_seed(0)  # every turn draws the same RANSAC seeds
            turns[name] = batch_bench.run_turn(dgr, kind, sx, sy)
    ops = sorted({str(w.message) for w in caught
                  if "deterministic" in str(w.message)})
    l1, l2, many = turns["loop_1"], turns["loop_2"], turns["many"]
    key = lambda recs: [(r.branch, r.iterations) for r in recs]
    r = {"nondeterministic_ops": ops, "loop_s_per_pair": l2["s_per_pair"],
         "many_s_per_pair": many["s_per_pair"], "batch_s_per_pair": turns["batch"]["s_per_pair"],
         "loop_stage_s": {k: v / len(sx) for k, v in l2["register_stage_s"].items()},
         "records": [{"branch": b, **i} for b, i in key(l1["records"])],
         "launches": {k: turns[k]["launches"] for k in turns}}
    loop_gap = _pose_gaps(l1["T"], l2["T"])
    many_gap = _pose_gaps(many["T"], l1["T"])
    batch_gap = _pose_gaps(turns["batch"]["T"], l1["T"])
    r.update(loop_vs_loop_max=[max(g[0] for g in loop_gap), max(g[1] for g in loop_gap)],
             many_vs_loop_max=[max(g[0] for g in many_gap), max(g[1] for g in many_gap)],
             batch_vs_loop_deg=[g[0] for g in batch_gap],
             batch_vs_loop_m=[g[1] for g in batch_gap])
    print(json.dumps({"deterministic_stream": r}), flush=True)
    if not ops:
        same = (np.array_equal(l1["T"], l2["T"]) and np.array_equal(many["T"], l1["T"])
                and key(l1["records"]) == key(l2["records"]) == key(many["records"])
                and l1["launches"] == l2["launches"] == many["launches"])
        if not same:
            fail("deterministic mode: register_many and the two loops differ")
        return 0
    print(f"deterministic mode: no deterministic implementation on CUDA for {ops}",
          flush=True)
    mode = lambda recs: [(x.branch, x.iterations.get("icp_mode")) for x in recs]
    if not (mode(many["records"]) == mode(l1["records"]) == mode(l2["records"])
            and np.isfinite(many["T"]).all()):
        fail("deterministic mode: branches, ICP modes or finite poses differ")
    for p, (g, lg) in enumerate(zip(many_gap, loop_gap)):
        if g[0] > lg[0] + 0.05 or g[1] > lg[1] + 1e-3:
            fail(f"deterministic mode: pair {p} of register_many is {g} off the loop, "
                 f"the loops {lg} apart (allowance 0.05 deg, 1 mm)")
    return 0


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
        host clock between synchronisations, a warm-up first), in which
        ``slot_sum`` and ``slot_sum_rows`` (the SP families' pooling) must
        launch;
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
    reset_slot_counts()
    for name, (net, plan) in nets.items():
        ms[name], feats = _median_ms(lambda: net(plan, ones), 10)
        if feats.shape != (grid.shape[0], 32) or not bool(torch.isfinite(feats).all()):
            fail(f"models: {name} gave {tuple(feats.shape)} features, finite: "
                 f"{bool(torch.isfinite(feats).all())}")
    torch.cuda.synchronize()
    out["slot_launches"] = slot_counts()  # 11 forwards of each of the 47
    print(json.dumps({"models_slot_sum_launches": out["slot_launches"]}), flush=True)
    if min(out["slot_launches"]["slot_sum"], out["slot_launches"]["slot_sum_rows"]) < 1:
        fail(f"models: slot-sum launches {out['slot_launches']}: the convs or the "
             "SP families' sum pooling did not go through their kernels")
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


# KITTI odometry's velodyne -> cam0 extrinsics (column-vector convention),
# as tests/test_kitti_loader.py writes its fixture.
VELO_TO_CAM0 = np.eye(4)
VELO_TO_CAM0[:3, :3] = np.array([
    7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02, 7.280733e-04,
    -9.998902e-01, 9.998621e-01, 7.523790e-03, 1.480755e-02]).reshape(3, 3)
VELO_TO_CAM0[:3, 3] = [-4.069766e-03, -7.631618e-02, -2.717806e-01]
THREEDMATCH_SCENE = "7-scenes-redkitchen"  # scene 0 of the 3DMatch test split


class Recorder:
    """A method for the evaluation loops that keeps each register() answer
    and its iterations."""

    def __init__(self, dgr):
        self.dgr, self.Ts, self.iterations = dgr, [], []

    def register(self, xyz0, xyz1):
        T = self.dgr.register(xyz0, xyz1)
        self.Ts.append(T)
        self.iterations.append(dict(self.dgr.last_iterations))
        return T


def _pose_z(deg: float, t) -> np.ndarray:
    P = np.eye(4)
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    P[:2, :2] = [[c, -s], [s, c]]
    P[:3, 3] = t
    return P


def write_kitti_fixture(root: Path, seed: int = 0) -> dict:
    """A drive of 120k-point LiDAR-like scans (``lidar_like_pair``'s
    geometry) in KITTI odometry's layout: drive 08, scans 0, 2 and 4, each
    the points of scan 0 re-expressed in the velo frame of its cam0 pose
    (yaw 1 deg and 1.5 m a step), and the poses file; drives 09 and 10 (the
    rest of the test split) one scan each, so they give no pair. Returns
    {(t0, t1): the exact velo_t0 -> velo_t1 transform}."""
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    xyz0 = lidar_like_pair(seed=seed)[0].astype(np.float64)
    poses = [_pose_z(1.0 * t, (1.5 * t, 0.1 * t, 0.0)) for t in range(5)]
    tr, tr_inv = VELO_TO_CAM0, np.linalg.inv(VELO_TO_CAM0)

    def velo(t0, t1):
        return tr_inv @ np.linalg.inv(poses[t1]) @ poses[t0] @ tr

    seq = root / "dataset" / "sequences"
    for drive, scans in ((8, (0, 2, 4)), (9, (0,)), (10, (0,))):
        (seq / f"{drive:02d}" / "velodyne").mkdir(parents=True)
        for t in scans:
            M = velo(0, t)
            pts = np.ones((len(xyz0), 4), np.float32)
            pts[:, :3] = xyz0 @ M[:3, :3].T + M[:3, 3]
            pts.tofile(seq / f"{drive:02d}" / "velodyne" / f"{t:06d}.bin")
    (root / "dataset" / "poses").mkdir(parents=True)
    np.savetxt(root / "dataset" / "poses" / "08.txt",
               np.stack([P[:3].reshape(12) for P in poses]))
    return {(0, 2): velo(0, 2), (2, 4): velo(2, 4)}


def _library_nn1_ms(F0, F1) -> float | None:
    """``torch.cdist`` + ``argmin`` over the whole [N0, N1] distance matrix
    (cdist's one large allocation), when it fits the card's free memory
    after the allocator's cache is emptied; else None."""
    need = F0.shape[0] * F1.shape[0] * 4
    if need > 2 ** 30:
        torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    if need > 0.85 * free:
        print(f"library_ms: the {F0.shape[0]} x {F1.shape[0]} distance matrix "
              f"({need / 2 ** 30:.1f} GiB) does not fit in {free / 2 ** 30:.1f} "
              "GiB free: not measured", flush=True)
        return None
    ms = cuda_ms(lambda: torch.cdist(F0, F1).argmin(1), 5)
    if need > 2 ** 30:
        torch.cuda.empty_cache()
    return ms


def _register_s_per_pair(dgr, pairs) -> float:
    """register() over the pairs, host clock, s/pair."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in pairs:
        dgr.register(p[0], p[1])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(pairs)


def phase_eval(knn, bench_pairs, bench_Ts) -> dict:
    """The evaluation entry points on the card, each a path of its own with
    the launch counts set to 0 just before and read just after:
    (a) ``demo.main([])``: the bundled weights, the synthetic pair, held to
        success at 0.3 m / 15 deg and to rre <= 1 deg, rte <= 10 cm;
    (b) the 3DMatch script's ``evaluate`` over ``ThreeDMatchTrajectoryDataset``
        at the bench configuration, on the four bench pairs written as
        binary PLY fragments with a gt.log (poses inv(T_gt)): recall 1.0,
        mean rre <= 1 deg and rte <= 10 cm, the npz (1, 4, 5), one nn1_mma a
        pair and one nn1_scan an ICP step; each pose's gap to phase 4's
        register() of the same pair is printed, not held;
    (c) the KITTI script's loader (``make_data_loader`` as its ``main``
        builds it, two workers) over a KITTI-layout drive of 120k-point
        scans at the KITTI-scale configuration: the ground truth is computed
        on the card in this process before the workers start (its own
        path, ``launches_kitti_gt``) and must lie within 0.1 deg and 1 cm of
        the fixture's exact transform; the first pair's last ground-truth
        ICP scan against the plain version, bit for bit, and timed; then
        ``evaluate`` (poses not held: random nets).
    Each loop's s/pair is printed beside register()'s on the same pairs and
    instance just before and after it, and the KITTI loader's host time an
    item (``dataset[k]`` in this process)."""
    import tempfile

    from deepglobalregistration_tpu_torch import demo
    from deepglobalregistration_tpu_torch.config import default_config, get_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader
    from deepglobalregistration_tpu_torch.data.threedmatch import (
        ThreeDMatchTrajectoryDataset)
    from deepglobalregistration_tpu_torch.scripts import test_3dmatch, test_kitti
    from deepglobalregistration_tpu_torch.utils.file import CameraPose, write_trajectory
    from deepglobalregistration_tpu_torch.utils.pointcloud import write_point_cloud

    out = {}
    # (a) the demo.
    reset_counts(knn)
    t0 = time.perf_counter()
    r = demo.main([])
    torch.cuda.synchronize()
    r_demo = {"rre_deg": r["rre"], "rte_cm": r["rte"] * 100, "success": r["success"],
              "s": time.perf_counter() - t0, "nn1_launches": counts(knn)}
    print(json.dumps({"eval_demo": r_demo}), flush=True)
    if not r["success"] or r["rre"] > RRE_DEG or r["rte"] > RTE_M:
        fail(f"demo: {r_demo} (limits 1 deg / 10 cm)")
    if r_demo["nn1_launches"]["nn1_mma"] < 1 or r_demo["nn1_launches"]["nn1_scan"] < 1:
        fail(f"demo: nn1 launches {r_demo['nn1_launches']}")
    out["demo"] = r_demo["nn1_launches"]

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        # (b) the 3DMatch loop.
        scene = d / "3dmatch" / THREEDMATCH_SCENE
        scene.mkdir(parents=True)
        (d / "3dmatch" / f"{THREEDMATCH_SCENE}-evaluation").mkdir()
        traj = []
        for k, (xyz0, xyz1, T_gt) in enumerate(bench_pairs):
            write_point_cloud(scene / f"cloud_bin_{2 * k}.ply", xyz0)
            write_point_cloud(scene / f"cloud_bin_{2 * k + 1}.ply", xyz1)
            traj.append(CameraPose([2 * k, 2 * k + 1, 2 * len(bench_pairs)],
                                   np.linalg.inv(T_gt.astype(np.float64))))
        write_trajectory(traj, d / "3dmatch" / f"{THREEDMATCH_SCENE}-evaluation" / "gt.log")
        cfg = default_config(bf16=True, threed_match_dir=str(d / "3dmatch"),
                             out_dir=str(d / "out"), **BENCH)
        dgr = DeepGlobalRegistration(cfg, device=cfg.device)
        dgr.register(bench_pairs[0][0], bench_pairs[0][1])  # warm-up
        dset = ThreeDMatchTrajectoryDataset("test", random_scale=False,
                                            random_rotation=False, scene_id=0, config=cfg)
        loader = torch.utils.data.DataLoader(dset, batch_size=1, shuffle=False,
                                             collate_fn=test_3dmatch._identity)
        method = Recorder(dgr)
        direct = [_register_s_per_pair(dgr, bench_pairs)]
        reset_counts(knn)
        t0 = time.perf_counter()
        stats = test_3dmatch.evaluate([method], ["DGR-torch"], loader, cfg)
        torch.cuda.synchronize()
        s_pair = (time.perf_counter() - t0) / len(bench_pairs)
        launches = counts(knn)
        direct.append(_register_s_per_pair(dgr, bench_pairs))
        saved = np.load(d / "out" / "3dmatch-stats.npz")["stats"]
        icp_steps = sum(i.get("icp", 0) for i in method.iterations)
        r3 = {"recall": float(stats[0, :, 0].mean()),
              "rre_deg": float(stats[0, :, 2].mean()),
              "rte_cm": float(stats[0, :, 1].mean() * 100),
              "s_per_pair": s_pair, "register_s_per_pair": float(stats[0, :, 3].mean()),
              "direct_register_s_per_pair_before_after": direct,
              "npz_shape": list(saved.shape), "icp_steps": icp_steps,
              "max_abs_T_gap_to_phase_4": [float(np.abs(a - b).max())
                                           for a, b in zip(method.Ts, bench_Ts)],
              "nn1_launches": launches}
        print(json.dumps({"eval_3dmatch": r3}), flush=True)
        if r3["recall"] != 1.0 or r3["rre_deg"] > RRE_DEG or r3["rte_cm"] > RTE_M * 100:
            fail(f"3DMatch loop: {r3} (recall 1, limits 1 deg / 10 cm)")
        if saved.shape != (1, len(bench_pairs), 5):
            fail(f"3DMatch loop: npz of shape {saved.shape}")
        if launches["nn1_mma"] != len(bench_pairs) or launches["nn1_scan"] < icp_steps:
            fail(f"3DMatch loop: nn1 launches {launches}, expected nn1_mma "
                 f"{len(bench_pairs)} and nn1_scan >= {icp_steps}")
        out["3dmatch"] = launches

        # (c) the KITTI loop.
        exact = write_kitti_fixture(d / "kitti")
        cfg = get_config([
            "--dataset", "KITTIPairDataset", "--kitti_dir", str(d / "kitti"),
            "--kitti_max_time_diff", "3", "--icp_cache_path", str(d / "icp"),
            "--out_dir", str(d / "out"), "--bf16", "true",
            *[a for k, v in KITTI.items() for a in (f"--{k}", str(v))]])
        dgr = DeepGlobalRegistration(cfg, device=cfg.device)
        reset_counts(knn)
        t0 = time.perf_counter()
        loader = make_data_loader(cfg, "test", batch_size=1,
                                  num_workers=cfg.test_num_workers, shuffle=False)
        torch.cuda.synchronize()
        gt_s = time.perf_counter() - t0
        gt_launches = counts(knn)
        ds = loader.dataset
        gt_err = {}
        for (drive, t0_, t1_) in ds.files:
            M2 = np.load(d / "icp" / f"{drive}_{t0_}_{t1_}.npy")
            gt_err[f"{t0_}_{t1_}"] = pose_errors(M2, exact[(t0_, t1_)])
        print(json.dumps({"kitti_gt": {
            "pairs": ds.files, "workers": loader.num_workers, "gt_log": ds.gt_log,
            "prepare_s": gt_s, "err_deg_m": gt_err, "nn1_launches": gt_launches}}),
            flush=True)
        if sorted(f[1:] for f in ds.files) != sorted(exact) or len(ds.gt_log) != len(exact):
            fail(f"KITTI loop: pairs {ds.files}, ground-truth ICP runs {ds.gt_log}")
        if any(e[0] > 0.1 or e[1] > 0.01 for e in gt_err.values()):
            fail(f"KITTI loop: ground truth off the fixture's exact pose {gt_err} "
                 "(limits 0.1 deg / 1 cm)")
        if gt_launches["nn1_scan"] < sum(g["iterations"] + 1 for g in ds.gt_log):
            fail(f"KITTI ground truth: nn1 launches {gt_launches} for {ds.gt_log}")
        # The first pair's last ground-truth scan: the source at its final pose.
        M, src, tgt = ds.icp_inputs(*ds.load_scans(0))
        M2 = np.load(d / "icp" / ("%d_%d_%d.npy" % ds.files[0]))
        T_icp = torch.as_tensor(np.linalg.inv(M) @ M2, dtype=torch.float32, device="cuda")
        from deepglobalregistration_tpu_torch.ops import se3

        moved = se3.apply_transform(torch.as_tensor(src, device="cuda"), T_icp).contiguous()
        tgt = torch.as_tensor(tgt, device="cuda")
        timing = time_nn1(knn, moved, tgt, "KITTI ground-truth ICP scan (pair 0)",
                          bitwise=True)

        item_s, items = [], []
        for k in range(len(ds)):  # the loader's host work, in this process
            t0 = time.perf_counter()
            items.append(ds[k][:2])
            item_s.append(time.perf_counter() - t0)
        method = Recorder(dgr)
        dgr.register(*items[0])  # warm-up
        direct = [_register_s_per_pair(dgr, items)]
        dgr.cand_fallbacks = 0
        reset_counts(knn)
        t0 = time.perf_counter()
        stats = test_kitti.evaluate(cfg, loader, method)
        torch.cuda.synchronize()
        s_pair = (time.perf_counter() - t0) / len(ds)
        launches = counts(knn)
        fallbacks = dgr.cand_fallbacks
        direct.append(_register_s_per_pair(dgr, items))
        rk = {"s_per_pair": s_pair, "register_s_per_pair": float(stats[:, 3].mean()),
              "direct_register_s_per_pair_before_after": direct,
              "loader_item_host_s": item_s, "cand_fallbacks": fallbacks,
              "loop_minus_register_s_per_pair": s_pair - float(stats[:, 3].mean()),
              "informational_recall": float(stats[:, 0].mean()),
              "informational_rre_deg": stats[:, 2].tolist(),
              "icp_mode_per_pair": [i.get("icp_mode") for i in method.iterations],
              "gt_icp_iterations": [g["iterations"] for g in ds.gt_log],
              "gt_icp_s_per_pair": [g["s"] for g in ds.gt_log],
              "gt_icp_rows": [g["rows"] for g in ds.gt_log],
              "npz": (d / "out" / "kitti-stats.npz").exists(), "nn1_launches": launches}
        print(json.dumps({"eval_kitti": rk}), flush=True)
        if not rk["npz"] or stats.shape != (len(ds), 5) or not np.isfinite(stats).all():
            fail(f"KITTI loop: stats {stats.shape}, npz written {rk['npz']}")
        # One match a pair; candidate-list ICP scans only on a fallback.
        if launches["nn1_mma"] != len(ds) or launches["nn1_scan"] < fallbacks:
            fail(f"KITTI loop: nn1 launches {launches} for {len(ds)} pairs and "
                 f"{fallbacks} full-scan fallbacks")
        out["kitti"], out["kitti_gt"], out["kitti_gt_timing"] = launches, gt_launches, timing
    return out


# The training phase (13): the bench configuration trained as the JAX
# package's trainer does (bench.py:44-50; SGD at the config's defaults).
TRAIN = dict(BENCH, dataset="SyntheticPairDataset", synthetic_points=30000,
             batch_size=4)
TRAIN_SMALL = dict(synthetic_points=4000, batch_size=2)  # the card-vs-CPU step
# Card against CPU, one step from the same parameters on the same 1-NN
# indices (the card's): the card's GEMMs and reductions sum in another
# order than the CPU's. Loss, logits and BN statistics: the largest gap over the largest
# |value| of the tensor; gradients and updated parameters: over the largest
# |value| of any leaf, since a leaf whose gradient cancels to near zero (a
# BN bias feeding a train-mode BN) has no scale of its own; each leaf's own
# relative gap is printed. Measured (NVIDIA H100 80GB HBM3, 700 W; 2 pairs
# of ~3k voxels; five runs): loss 7.7e-8 to 2.3e-7, logits 5.3e-7 to
# 6.0e-7, BN statistics 5.7e-6 to 5.8e-6, gradients 8.3e-7 and parameters
# 1.2e-7 of the largest leaf; one leaf's own gap 6.5e-6 to 1.7e-3 between
# runs (block3.norm1.bias).
TRAIN_CARD_CPU_TOL = {"loss": 1e-5, "logits": 1e-5, "grads": 1e-4, "params": 1e-4,
                      "bn_state": 5e-5}
FCGF_TRAIN_LR = 0.01  # fine-tuning the committed weights


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _train_card_vs_cpu() -> dict:
    """One train step on the card and on the CPU from the same parameters,
    2 pairs at 4000 points, the CPU fed the card's 1-NN indices; returns
    each quantity's largest gap relative to its largest |value|."""
    import tempfile

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core import train_step as ts
    from deepglobalregistration_tpu_torch.core.trainer import WeightedProcrustesTrainer
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader

    steps, nets = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, dev in (("card", "cuda"), ("host", "cpu")):
            config = default_config(**dict(TRAIN, **TRAIN_SMALL), device=dev,
                                    out_dir=f"{tmp}/{side}", test_valid=False)
            loader = make_data_loader(config, "train", config.batch_size)
            nets[side] = WeightedProcrustesTrainer(config, loader)
    batch = next(iter(loader))["pair_batch"]
    t0 = time.perf_counter()
    card = nets["card"].step_fn(ts.batch_to(batch, "cuda"))
    torch.cuda.synchronize()
    steps["card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = nets["host"].step_fn(ts.batch_to(batch, "cpu"), card["nn_idx"].cpu())
    steps["host_s"] = time.perf_counter() - t0
    if not torch.equal(card["nn_idx"].cpu(), host["nn_idx"]):
        fail("train card vs CPU: the CPU step did not take the card's 1-NN indices")
    valid = card["valid"].cpu()
    gaps = {"loss": _rel_gap(card["loss"], host["loss"]),
            "logits": _rel_gap(card["logits"].cpu()[valid], host["logits"][valid])}
    pc = dict(nets["card"].inlier.named_parameters())
    ph = dict(nets["host"].inlier.named_parameters())
    for key, get in (("grads", lambda p: p.grad), ("params", lambda p: p)):
        diff = max(float((get(pc[k]).detach().cpu() - get(ph[k]).detach()).abs().max())
                   for k in pc)
        gaps[key] = diff / max(float(get(ph[k]).detach().abs().max()) for k in ph)
    bc = dict(nets["card"].inlier.named_buffers())
    bh = dict(nets["host"].inlier.named_buffers())
    gaps["bn_state"] = max(_rel_gap(bc[k], bh[k]) for k in bc)
    worst_grad = max(pc, key=lambda k: _rel_gap(pc[k].grad, ph[k].grad))
    worst = {"leaf": worst_grad, "gap_of_leaf_max": _rel_gap(pc[worst_grad].grad,
                                                            ph[worst_grad].grad),
             "leaf_max": float(ph[worst_grad].grad.abs().max())}
    r = {"pairs": int(batch.num0.shape[0]), "num0": batch.num0.tolist(),
         "num1": batch.num1.tolist(), "gaps": gaps, "worst_grad_leaf": worst,
         "tolerances": TRAIN_CARD_CPU_TOL, **steps,
         "labels_equal": bool(torch.equal(card["labels"].cpu(), host["labels"]))}
    print(json.dumps({"train_card_vs_cpu": r}), flush=True)
    if not r["labels_equal"]:
        fail("train card vs CPU: the labels differ on the same 1-NN indices")
    for k, tol in TRAIN_CARD_CPU_TOL.items():
        if not gaps[k] <= tol:
            fail(f"train card vs CPU: {k} gap {gaps[k]:.3e} over {tol}")
    return r


def _train_repeat(trainer, batch) -> dict:
    """One train step twice from the same state (the inlier net, its
    optimizer, the seeds): each leaf's gradient and updated value, the gap
    between the two steps over the leaf's largest |value| (a remaining
    atomic accumulation outside the conv shows here); and the conv's own
    gradients: every ``_SparseConv`` backward of the first step run twice
    more on its own inputs, dx and dk bit for bit the step's."""
    import copy

    from deepglobalregistration_tpu_torch.ops import sparse_conv as sc

    net, opt = trainer.inlier, trainer.optimizer
    state, opt_state = copy.deepcopy(net.state_dict()), copy.deepcopy(opt.state_dict())
    backward, calls = sc._SparseConv.backward, []

    def recording(ctx, dy):
        # Cloned: the optimizer updates the saved kernel (the parameter
        # itself) in place, and autograd may add into a gradient it is given.
        saved = [t.clone() for t in ctx.saved_tensors]
        grads = backward(ctx, dy)
        calls.append((saved, ctx.em, ctx.needs_input_grad, dy,
                      [None if t is None else t.clone() for t in grads]))
        return grads

    steps = []
    for run in range(2):
        net.load_state_dict(state)
        # A copy each time: the optimizer adopts the loaded buffers (momentum)
        # and updates them in place.
        opt.load_state_dict(copy.deepcopy(opt_state))
        torch.manual_seed(0)
        sc._SparseConv.backward = staticmethod(recording) if run == 0 else backward
        try:
            trainer.step_fn(batch)
        finally:
            sc._SparseConv.backward = backward
        torch.cuda.synchronize()
        steps.append({k: (p.grad.detach().clone(), p.detach().clone())
                      for k, p in net.named_parameters() if p.grad is not None})
    gaps = {k: [_rel_gap(steps[0][k][i], steps[1][k][i]) for i in (0, 1)]
            for k in steps[0]}

    class _Ctx:  # what backward reads of its context
        pass

    conv_same = 0
    for saved, em, needs, dy, (dx, dk, _) in calls:
        for _ in range(2):
            ctx = _Ctx()
            ctx.saved_tensors, ctx.em, ctx.needs_input_grad = saved, em, needs
            dx2, dk2, _ = backward(ctx, dy)
            for a, b in ((dx, dx2), (dk, dk2)):
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    fail("train: a conv backward run again on its own inputs "
                         "differs from the step's (dx or dk)")
        conv_same += 1
    differ = {k: g for k, g in gaps.items() if g[0] > 0 or g[1] > 0}
    r = {"leaves": len(gaps), "leaves_bit_for_bit": len(gaps) - len(differ),
         "conv_backwards_bit_for_bit": conv_same,
         "max_grad_gap": max(g[0] for g in gaps.values()),
         "max_param_gap": max(g[1] for g in gaps.values()),
         "differing_leaves_grad_param_gap": differ}
    print(json.dumps({"train_repeat": r}), flush=True)
    if conv_same == 0:
        fail("train: no conv backward ran in the step")
    net.load_state_dict(state)
    opt.load_state_dict(copy.deepcopy(opt_state))
    return r


def phase_train(knn) -> dict:
    """Training on the card (the slice of core/train_step.py, core/trainer.py,
    train.py and core/fcgf_train.py) at the bench configuration, full width:
    FCGF ResUNetBN2C conv1 = 7 / 32-dim from the committed weights (frozen),
    the 6D ResUNetBN2C conv1 = 3 inlier net from a seeded generator, SGD at
    the config's defaults, SyntheticPairDataset at 30000 points and 5 cm,
    batch 4:
    (a) 8 steps on one batch: finite loss, finite gradients, the last loss
        below the first;
    (b) one step with the launch counts set to 0 just before and read just
        after: nn1_mma_batched exactly once, nothing else; that launch's
        indices equal the kernel's on the step's features, held to the plain
        version (check_nn1_batched) and timed (time_nn1_batched);
    (c) stage split, s/step (median of 5 after a warm-up), peak memory a step
        with and without --remat, and the device busy share of one step;
    (d) one step on the card against the CPU (_train_card_vs_cpu);
    (e) train.main: 1 epoch of 3 steps with validation, f32 uncompressed
        checkpoints; the scalar tags and checkpoint.pkl; --resume_dir
        restores the epoch and the inlier net bit for bit; the checkpoint
        as DeepGlobalRegistration's weights: a trained inlier net and a
        finite pose on bench pair 0;
    (f) 4 hardest-contrastive FCGF steps (core/fcgf_train.py) at full width
        in train-mode BN on the batch, fixed draws: finite, falling loss;
    (g) after (b), one step twice from the same state (_train_repeat): every
        conv backward's dx and dk bit for bit on its own inputs, and each
        leaf's gap between the two steps."""
    import dataclasses
    import tempfile

    from deepglobalregistration_tpu_torch import train
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core import fcgf_train as ft
    from deepglobalregistration_tpu_torch.core import train_step as ts
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.core.trainer import WeightedProcrustesTrainer
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader
    from deepglobalregistration_tpu_torch.models import load_model
    from deepglobalregistration_tpu_torch.utils import checkpoint, convert
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair
    from deepglobalregistration_tpu_torch.utils.timer import Timer

    out = {}
    tmp = tempfile.TemporaryDirectory()
    config = default_config(**TRAIN, device="cuda", out_dir=f"{tmp.name}/a",
                            test_valid=False)
    loader = make_data_loader(config, "train", config.batch_size)
    t0 = time.time()
    trainer = WeightedProcrustesTrainer(config, loader)
    host_batch = next(iter(loader))["pair_batch"]
    batch = ts.batch_to(host_batch, "cuda")
    print(f"train: trainer {time.time() - t0:.3f} s; voxels per cloud num0 "
          f"{host_batch.num0.tolist()} num1 {host_batch.num1.tolist()}, bucket "
          f"{host_batch.xyz0.shape[1]}, positives {host_batch.pos_num.tolist()}",
          flush=True)

    # (a) a fixed batch, 8 steps
    losses, finite = [], []
    for _ in range(8):
        stats = trainer.step_fn(batch)
        losses.append(float(stats["loss"]))
        finite.append(stats["grad_finite"])
    print(json.dumps({"train_fixed_batch": {
        "loss": losses, "grad_finite": finite,
        "valid_pairs": int(stats["valid_pairs"])}}), flush=True)
    if not (all(finite) and np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train: 8 steps on one batch gave losses {losses}, finite grads {finite}")
    out["losses"] = losses

    # (b) the kernel on this path
    torch.cuda.synchronize()
    reset_counts(knn)
    stats = trainer.step_fn(batch)
    torch.cuda.synchronize()
    launches, slot = counts(knn), slot_counts()
    print(json.dumps({"train_step_launches": {**launches, **slot}}), flush=True)
    if launches["nn1_mma_batched"] != 1 or launches["total"] or \
            launches["nn1_scan_batched"]:
        fail(f"train: a step launched {launches}, expected nn1_mma_batched once")
    if not slot["slot_sum_runs"] or not slot["slot_sum"]:
        fail(f"train: a step launched the slot sums {slot}: the conv backwards' dk "
             "(slot_sum_runs) or the convs (slot_sum) left the kernels")
    out["launches"], out["slot_launches"] = launches, slot
    with torch.no_grad():
        feats = ts.fcgf_features(trainer.fcgf, batch)
    b = host_batch.num0.shape[0]
    F0, F1 = feats[:b].contiguous(), feats[b:].contiguous()
    num0, num1 = host_batch.num0.tolist(), host_batch.num1.tolist()
    idx, _ = knn.nn1_mma_batched(F0, F1, knn.pair_counts(num0, num1, "cuda"))
    if not torch.equal(idx.long(), stats["nn_idx"]):
        fail("train: the step's 1-NN indices differ from the kernel's on its features")
    out["max_abs_err"] = check_nn1_batched(knn, F0, F1, num0, num1,
                                           "train match")["max_abs_err"]
    out["num0"], out["num1"] = num0, num1
    out["timing"] = time_nn1_batched(knn, F0, F1, num0, num1, "train match")
    del feats, F0, F1
    out["repeat"] = _train_repeat(trainer, batch)

    # (c) numbers: stage split, s/step, peak memory, busy share
    stages = ("fcgf", "match", "plan6", "inlier", "loss", "backward", "optimizer")

    class StageTimer(Timer):
        """A stage's time and the peak memory allocated inside it."""

        peak_gib = 0.0

        def tic(self):
            torch.cuda.reset_peak_memory_stats()
            super().tic()

        def toc(self, average: bool = True):
            self.peak_gib = max(self.peak_gib,
                                torch.cuda.max_memory_allocated() / 2 ** 30)
            return super().toc(average)

    timers = {k: StageTimer() for k in stages}
    timed, _ = ts.make_train_step(trainer.fcgf, trainer.inlier, config,
                                  trainer.optimizer, timers)
    ms_step, _ = _median_ms(lambda: trainer.step_fn(batch), 5)
    timed(batch)
    for t in timers.values():
        t.reset()
    for _ in range(5):
        timed(batch)
    peak = {}
    for remat in (False, True):
        step, _ = ts.make_train_step(trainer.fcgf, trainer.inlier,
                                     dataclasses.replace(config, remat=remat),
                                     trainer.optimizer)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        peak["remat" if remat else "plain"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["step"] = {"s_per_step_median": ms_step / 1e3,
                   "stage_s_mean": {k: timers[k].avg for k in stages},
                   "stage_peak_gib": {k: timers[k].peak_gib for k in stages},
                   "peak_gib": peak, "card": card_line()}
    print(json.dumps({"train_step": out["step"]}), flush=True)
    busy = profile_busy(lambda: trainer.step_fn(batch), ms_step / 1e3, by_name="slot_")
    if busy is not None:
        print(json.dumps({"train_step_profile": busy}), flush=True)
    out["busy"] = busy
    del trainer, timed, step
    torch.cuda.empty_cache()

    # (d) card against CPU
    out["card_vs_cpu"] = _train_card_vs_cpu()

    # (e) the trainer end to end, resume, and the checkpoint as weights
    run = Path(tmp.name) / "run"
    argv = [a for k, v in dict(TRAIN, out_dir=str(run)).items()
            for a in (f"--{k}", str(v))]
    argv += ["--device", "cuda", "--max_epoch", "1", "--num_train_iter", "3",
             "--test_valid", "true",
             "--val_max_iter", "2", "--stat_freq", "1", "--ckpt_dtype", "f32",
             "--ckpt_compress", "false"]
    reset_counts(knn)
    t0 = time.time()
    first = train.main(argv)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    main_launches = counts(knn)
    tags = {json.loads(line)["tag"] for line in (run / "scalars.jsonl").open()}
    want = {"train/loss", "train/f1", "train/hit_ratio", "val/succ_rate", "val/rte",
            "val/rre", "val/hit_ratio"}
    if not want <= tags or not (run / "checkpoint.pkl").exists():
        fail(f"train.main: tags {sorted(tags)}, checkpoint "
             f"{(run / 'checkpoint.pkl').exists()}")
    t0 = time.time()
    resumed = train.main(["--resume_dir", str(run)])
    resume_s = time.time() - t0
    pa, pb = convert.to_jax_params(first.inlier), convert.to_jax_params(resumed.inlier)
    same = all(np.array_equal(a, b) for i in (0, 1)
               for a, b in zip(_tree_leaves(pa[i]), _tree_leaves(pb[i])))
    if resumed.start_epoch != 1 or not same:
        fail(f"train.main resume: start_epoch {resumed.start_epoch}, inlier net bit "
             f"for bit {same}")
    del first, resumed
    torch.cuda.empty_cache()
    dgr = DeepGlobalRegistration(default_config(
        **dict(BENCH, weights=str(run / "checkpoint.pkl"))), device="cuda")
    xyz0, xyz1, T_gt = synthetic_pair(n=30000, seed=0)
    T = dgr.register(xyz0, xyz1)
    rre, rte = pose_errors(T, T_gt)
    out["trainer"] = {"main_s": main_s, "resume_s": resume_s,
                      "launches": main_launches,
                      "checkpoint_mib": (run / "checkpoint.pkl").stat().st_size / 2 ** 20,
                      "inlier_trained": dgr.inlier_trained, "register_rre_deg": rre,
                      "register_rte_m": rte, "branch": dgr.last_branch}
    print(json.dumps({"train_main": out["trainer"]}), flush=True)
    if not dgr.inlier_trained or not np.isfinite(T).all():
        fail(f"train: the checkpoint as weights: inlier_trained "
             f"{dgr.inlier_trained}, pose finite {np.isfinite(T).all()}")
    del dgr

    # (f) the FCGF hardest-contrastive step, full width, train-mode BN
    spec = load_model(config.feat_model)
    fcfg = spec.make_config(1, config.feat_model_n_out,
                            conv1_kernel_size=config.feat_conv1_kernel_size,
                            normalize_feature=True, D=3, bn_momentum=config.bn_momentum)
    sd = checkpoint.load_checkpoint(WEIGHTS)["state_dict"]
    fnet = spec.module(fcfg)
    fnet.load_state_dict(convert.from_jax_params(sd["params"], sd["state"], fcfg))
    fnet.to("cuda").train()
    fopt = ts.make_optimizer("SGD", fnet.parameters(),
                             dataclasses.replace(config, lr=FCGF_TRAIN_LR))
    lcfg = ft.FCGFLossConfig()
    fstep, _ = ft.make_fcgf_train_step(fnet, lcfg, fopt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = [ft.draw_indices(gen, host_batch.pos_num[i], host_batch.num0[i],
                             host_batch.num1[i], lcfg) for i in range(b)]
    flosses, ffinite = [], []
    t0 = time.time()
    for _ in range(4):
        st = fstep(batch, draws)
        flosses.append(float(st["loss"]))
        ffinite.append(st["grad_finite"])
    torch.cuda.synchronize()
    out["fcgf"] = {"loss": flosses, "grad_finite": ffinite, "lr": FCGF_TRAIN_LR,
                   "s_per_step": (time.time() - t0) / 4}
    print(json.dumps({"train_fcgf": out["fcgf"]}), flush=True)
    if not (all(ffinite) and np.isfinite(flosses).all() and flosses[-1] < flosses[0]):
        fail(f"train: FCGF steps gave losses {flosses}, finite grads {ffinite}")
    tmp.cleanup()
    return out


# The data-parallel phase (14): two ranks share the one card through gloo
# (NCCL needs a card a rank), so it runs on a machine with one card.
PARALLEL_DEVICES = ["cuda:0", "cuda:0"]
# n ranks against one process, one step from the same parameters on the same
# 1-NN indices: the ranks sum BN moments, losses and gradients in another
# order than one process, as in card vs CPU (phase 13).
PARALLEL_TOL = {"loss": 1e-5, "grads": 1e-4, "params": 1e-4}


def _leaf_gap(got: dict, want: dict) -> float:
    """The largest |got - want| over the largest |want| of any leaf."""
    scale = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - v).abs().max()) for k, v in want.items()) / scale


def _parallel_train(n: int, devices, config, batch, label: str) -> dict:
    """The train step on ``n`` ranks (``devices``; None: a card each, NCCL):
    3 steps, then s/step and peak memory a rank; each rank's 1-NN of the
    first step equals nn1_mma_batched on that rank's shard features, and
    that launch is held to the plain version at the shard's shapes
    (check_nn1_batched); then against one step of the one-process step fed
    the ranks' 1-NN indices, twice (the second run gives the one process's
    own run-to-run spread)."""
    from deepglobalregistration_tpu_torch.ops import knn
    from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
    from deepglobalregistration_tpu_torch.tools.parallel_bench import train_rank

    t0 = time.time()
    ranks = dp.spawn(train_rank, n, config, batch, 3, 5, devices=devices)
    spawn_s = time.time() - t0
    r0 = ranks[0]
    per = len(batch.num0) // n
    match_err = []
    for r, rank in enumerate(ranks):
        m = rank["match"]
        F0, F1 = m["F0"].cuda(), m["F1"].cuda()
        idx, _ = knn.nn1_mma_batched(F0, F1, knn.pair_counts(m["num0"], m["num1"], "cuda"))
        if not torch.equal(idx.long().cpu(), r0["stats"]["nn_idx"][r * per:(r + 1) * per]):
            fail(f"parallel train{label}: rank {r}'s 1-NN indices differ from "
                 "nn1_mma_batched on its shard features")
        match_err.append(check_nn1_batched(
            knn, F0, F1, m["num0"], m["num1"],
            f"parallel train{label} rank {r}")["max_abs_err"])
        del F0, F1
    ones = [train_rank(None, config, batch, steps=1, timed=5 * (k == 0),
                       nn_idx=r0["stats"]["nn_idx"]) for k in range(2)]
    one = ones[0]

    def gaps(a):
        return {"loss": abs(a["loss"][0] - one["loss"][0]) / abs(one["loss"][0]),
                "grads": _leaf_gap(a["grads"], one["grads"]),
                "params": _leaf_gap(a["params_first"], one["params_first"])}

    per_step = [[lc["nn1_mma_batched"] for lc in r["launches"]] for r in ranks]
    g, w = r0["grads"], one["grads"]
    worst = max(w, key=lambda k: float((g[k] - w[k]).abs().max()))
    tr = {"ranks": n, "devices": dp.make_mesh(n, devices).devices,
          "backend": dp.make_mesh(n, devices).backend,
          "num0": batch.num0.tolist(), "num1": batch.num1.tolist(),
          "loss_ranks": [r["loss"] for r in ranks], "loss_one_process": one["loss"],
          "gaps": gaps(r0), "one_process_spread": gaps(ones[1]),
          "worst_grad_leaf": {"leaf": worst, "gap_of_leaf_max": _rel_gap(g[worst], w[worst]),
                              "leaf_max": float(w[worst].abs().max())},
          "tolerances": PARALLEL_TOL,
          "match_max_abs_err_ranks": match_err,
          "ranks_agree_after_3_steps": [r["ranks_agree"] for r in ranks],
          "nn1_mma_batched_per_rank_per_step": per_step,
          "launches_per_rank": [r["launches"] for r in ranks],
          "s_per_step_ranks": [r["s_per_step"] for r in ranks],
          "s_per_step_one_process": one["s_per_step"],
          "peak_gib_ranks": [r["peak_gib"] for r in ranks],
          "peak_gib_one_process": one["peak_gib"], "spawn_s": spawn_s,
          "card": card_line()}
    print(json.dumps({f"parallel_train{label}": tr}), flush=True)
    for k, tol in PARALLEL_TOL.items():
        if not tr["gaps"][k] <= tol:
            fail(f"parallel train{label}: {k} gap {tr['gaps'][k]:.3e} over {tol}")
    if not all(r["ranks_agree"] for r in ranks):
        fail(f"parallel train{label}: the ranks' parameters differ after 3 steps")
    if per_step != [[1, 1, 1]] * n or not all(all(r["grad_finite"]) for r in ranks):
        fail(f"parallel train{label}: nn1_mma_batched launches per rank per step "
             f"{per_step}")
    return tr


def _parallel_fanout(n: int, devices, config, stream, label: str) -> dict:
    """register_batch(mesh=...) of the ``stream`` pairs over ``n`` ranks,
    between two one-process register_batch(force_vmapped=True) runs (turns:
    one process, ranks, one process; each a counted call and 3 timed
    ones)."""
    from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
    from deepglobalregistration_tpu_torch.tools.parallel_bench import fanout_rank

    xs, ys = [p[0] for p in stream], [p[1] for p in stream]
    first = fanout_rank(None, config, xs, ys, reps=3)
    ranks = dp.spawn(fanout_rank, n, config, xs, ys, 3, devices=devices)
    second = fanout_rank(None, config, xs, ys, reps=3)
    T = ranks[0]["T"][0]
    errs = [pose_errors(Tp, p[2]) for Tp, p in zip(T, stream)]
    rre = float(np.mean([e[0] for e in errs]))
    rte = float(np.mean([e[1] for e in errs]))
    one_runs = first["T"] + second["T"]
    bits = ("gate", "cand_ok", "rerun")
    fan = {"ranks": n, "pairs": len(stream),
           "bits": {k: ranks[0]["last_batch"][k] for k in bits},
           "bits_equal_one_process": all(r["last_batch"][k] == first["last_batch"][k]
                                         for r in ranks for k in bits),
           "ranks_equal": all(np.array_equal(r["T"][0], T) for r in ranks),
           "rre_deg": rre, "rte_cm": rte * 100,
           "rre_deg_per_pair": [e[0] for e in errs],
           "rte_cm_per_pair": [e[1] * 100 for e in errs],
           "max_abs_T_ranks_minus_one_process": float(np.abs(T - first["T"][0]).max()),
           "max_abs_T_one_process_spread": max(
               float(np.abs(a - one_runs[0]).max()) for a in one_runs[1:]),
           "s_per_pair_one_process_turns": [first["s_per_pair"], second["s_per_pair"]],
           "s_per_pair_ranks": [r["s_per_pair"] for r in ranks],
           "peak_gib_ranks": [r["peak_gib"] for r in ranks],
           "peak_gib_one_process": first["peak_gib"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "launches_one_process": first["launches"], "card": card_line()}
    print(json.dumps({f"parallel_fanout{label}": fan}), flush=True)
    if not (fan["bits_equal_one_process"] and fan["ranks_equal"]):
        fail(f"parallel fan-out{label}: bits {fan['bits']} against one process "
             f"{first['last_batch']}, ranks equal {fan['ranks_equal']}")
    if not np.isfinite(T).all() or rre > RRE_DEG or rte > RTE_M:
        fail(f"parallel fan-out{label}: mean rre {rre:.3f} deg / rte "
             f"{rte * 100:.2f} cm (limits 1 deg / 10 cm)")
    per_sub = -(-len(stream) // n)  # pairs a rank, in sub-batches of 4
    if [r["launches"]["nn1_mma_batched"] for r in ranks] != [-(-per_sub // 4)] * n:
        fail(f"parallel fan-out{label}: launches {fan['launches_per_rank']}")
    return fan


def _parallel_inputs():
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    config = default_config(**TRAIN, device="cuda", test_valid=False)
    batch = next(iter(make_data_loader(config, "train", config.batch_size)))["pair_batch"]
    stream = [synthetic_pair(n=30000, seed=i % 4) for i in range(8)]
    return config, batch, default_config(bf16=True, device="cuda", **BENCH), stream


def phase_parallel(knn) -> dict:
    """Data parallelism (parallel/data_parallel.py) on the card, through the
    rank programs of ``tools/parallel_bench.py`` (each rank a process of
    ``data_parallel.spawn``; launches counted in each rank's process):
    (a) the train step at the training phase's configuration (bench batch
        4, committed FCGF weights, seeded 6D net) on 2 ranks sharing cuda:0
        (gloo): held against the one-process step on the same batch fed
        the ranks' 1-NN indices, each rank's indices first held to
        nn1_mma_batched on its shard features and that launch to the
        plain version at the shard's shapes (loss 1e-5 relative, gradients
        and updated parameters 1e-4 of the largest leaf's), the ranks' parameters and
        BN statistics bit for bit after 3 steps, exactly one
        nn1_mma_batched launch a rank a step; s/step and peak memory a rank
        beside the one process's (``_parallel_train``);
    (b) register_batch(mesh=...) on bench.py's 8-pair stream over the 2
        ranks against the one-process register_batch(force_vmapped=True):
        equal gate, cand_ok and rerun bits, the bench pose limits, the
        largest T gap beside the one-process runs' own spread, s/pair in
        turns, the launches a rank (``_parallel_fanout``);
    (c) no fallback: make_mesh(2) and train.main --num_devices 2 raise with
        one card visible; NCCL on ["cuda:0", "cuda:0"] raises;
    (d) with 2 or more cards, ``phase_parallel_nccl`` at min(cards, 4);
        else one line says NCCL at more than one rank was not run."""
    import tempfile

    from deepglobalregistration_tpu_torch import train
    from deepglobalregistration_tpu_torch.parallel import data_parallel as dp

    config, batch, bconfig, stream = _parallel_inputs()
    out = {"train": _parallel_train(2, PARALLEL_DEVICES, config, batch, ""),
           "fanout": _parallel_fanout(2, PARALLEL_DEVICES, bconfig, stream, "")}
    raised = {}
    cards = torch.cuda.device_count()
    checks = [("nccl_shared_card", lambda: dp.make_mesh(
        2, devices=PARALLEL_DEVICES, backend="nccl"))]
    if cards == 1:
        argv = [a for k, v in dict(TRAIN, out_dir=tempfile.mkdtemp()).items()
                for a in (f"--{k}", str(v))] + ["--num_devices", "2"]
        checks += [("make_mesh_2", lambda: dp.make_mesh(2)),
                   ("train_main_num_devices_2", lambda: train.main(argv))]
    for name, fn in checks:
        try:
            fn()
        except (RuntimeError, ValueError) as e:
            raised[name] = str(e)
        else:
            fail(f"parallel: {name} did not raise")
    print(json.dumps({"parallel_no_fallback": raised}), flush=True)
    if cards >= 2:
        out["nccl"] = phase_parallel_nccl(min(cards, 4))
    else:
        print(f"parallel: NCCL at more than one rank not run: {cards} card visible",
              flush=True)
    return out


def phase_parallel_nccl(n: int) -> dict:
    """NCCL over ``n`` cards, a card a rank: the JAX package's dry runs
    (``dryrun_step``, ``dryrun_fanout``), then ``_parallel_train`` (when n
    divides the batch of 4) and ``_parallel_fanout`` at the bench
    configuration, held as in phase 14."""
    from deepglobalregistration_tpu_torch.parallel import data_parallel as dp

    config, batch, bconfig, stream = _parallel_inputs()
    out = {"n": n, "dryrun_step_loss": dp.dryrun_step(n),
           "dryrun_fanout_finite": bool(np.isfinite(dp.dryrun_fanout(n)).all())}
    print(json.dumps({"parallel_nccl_dryruns": out}), flush=True)
    if config.batch_size % n == 0:
        out["train"] = _parallel_train(n, None, config, batch, "_nccl")
    out["fanout"] = _parallel_fanout(n, None, bconfig, stream, "_nccl")
    return out


# The tail (15): the synthetic train -> validate -> benchmark chain, TSDF
# fragment integration, the profiler and the tools.
# The summary keys of the repo's tools/synthetic_e2e.py (docs/e2e_r04_smoke).
CHAIN_KEYS = ("n_points", "fcgf_steps", "max_epoch", "iters_per_epoch",
              "fcgf_final_loss", "fcgf_val_hit_ratio", "best_val", "best_val_epoch",
              "recall", "te", "re", "mean_time_s", "n_pairs", "stats_npz")
TSDF_FRAMES = 10
TSDF_CARD_CPU_TOL = 1e-6
TSDF_CUT = dict(voxel_size=0.02, bbox_min=(-1, -1, 0), bbox_max=(1, 1, 2))
NN1_KERNELS = {"nn1_mma": "mma_kernel", "nn1_scan": "scan_kernel"}  # trace names


def room_depth_sequence(seed: int = 0, frames: int = TSDF_FRAMES, h: int = 480,
                        w: int = 640):
    """A seeded depth sequence (meters, f32 [h, w]) of a box room 5.6 x 5.6 x
    2.9 m inside the TSDF tool's default volume, rendered in numpy from
    cameras at seeded positions, headings and down-tilts; returns (depths,
    camera->world poses [frames, 4, 4], K)."""
    rng = np.random.RandomState(seed)
    K = np.array([[525.0, 0, (w - 1) / 2], [0, 525.0, (h - 1) / 2], [0, 0, 1]])
    lo, hi = np.array([-2.8, -2.8, 0.1]), np.array([2.8, 2.8, 3.0])
    v, u = np.mgrid[0:h, 0:w]
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                     np.ones_like(u, float)], -1).reshape(-1, 3)
    depths, poses = [], []
    for _ in range(frames):
        yaw, pitch = rng.uniform(0, 2 * np.pi), rng.uniform(-0.6, 0.0)
        c = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(1.2, 1.8)])
        fwd = np.array([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw),
                        np.sin(pitch)])
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], 1)  # camera -> world
        d = rays @ R.T
        with np.errstate(divide="ignore"):
            s = np.where(d > 0, (hi - c) / d, np.where(d < 0, (lo - c) / d, np.inf))
        depth = s.min(1).reshape(h, w) + rng.randn(h, w) * 0.002
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, c
        depths.append(depth.astype(np.float32))
        poses.append(pose)
    return depths, np.stack(poses), K


def _tail_chain(knn, tmp: Path) -> dict:
    """(a) synthetic_e2e --quick (room profile, full-width nets) with the
    counts set to 0 just before and read just after; then the hit probe's
    launch held against its unbatched launches and the plain version."""
    from deepglobalregistration_tpu_torch.core import train_step as ts
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader
    from deepglobalregistration_tpu_torch.tools import synthetic_e2e as e2e
    from deepglobalregistration_tpu_torch.utils import checkpoint, convert

    out = tmp / "chain"
    argv = ["--quick", "--out_dir", str(out)]
    torch.cuda.synchronize()
    reset_counts(knn)
    t0 = time.time()
    summary = e2e.main(argv)
    torch.cuda.synchronize()
    chain_s = time.time() - t0
    launches = counts(knn)
    stats = np.load(out / "3dmatch-stats.npz")["stats"]
    r = {k: summary.get(k) for k in ("fcgf_losses", "fcgf_val_hit_ratio", "best_val",
                                     "recall", "te", "re", "mean_time_s", "n_pairs",
                                     "stage_s", "card")}
    r.update(chain_s=chain_s, launches=launches, stats_shape=list(stats.shape),
             launches_by_stage=summary.get("launches"))
    print(json.dumps({"tail_chain": r}), flush=True)
    missing = [k for k in CHAIN_KEYS if k not in summary]
    if missing:
        fail(f"tail chain: summary.json lacks {missing}")
    if not np.isfinite(summary["fcgf_losses"]).all():
        fail(f"tail chain: stage A losses {summary['fcgf_losses']}")
    for f in ("fcgf_selftrained.pkl", "checkpoint.pkl", "best_val_checkpoint.pkl"):
        if not (out / f).exists():
            fail(f"tail chain: {f} not written")
    if stats.shape != (1, summary["n_pairs"], 5) or summary["n_pairs"] != 2:
        fail(f"tail chain: stats npz {stats.shape}, n_pairs {summary['n_pairs']}")
    by = summary["launches"]
    if by["a"]["nn1_mma_batched"] < 1 or by["b"]["nn1_mma_batched"] < 1 or \
            by["c"]["nn1_mma"] < 2 or by["c"]["nn1_scan"] < 2:
        fail(f"tail chain: 1-NN launches by stage {by}")

    # The hit probe's launch on stage A's net and the probe batch.
    config, _ = e2e.build_config(e2e.parse_args(argv))
    net = e2e.fcgf_net(config, "cuda")
    sd = checkpoint.load_checkpoint(out / "fcgf_selftrained.pkl")["state_dict"]
    net.load_state_dict(convert.from_jax_params(sd["params"], sd["state"], net.cfg))
    batch = ts.batch_to(next(iter(make_data_loader(config, "val", config.batch_size)))
                        ["pair_batch"], "cuda")
    feats, idx = e2e.probe_match(net, batch)
    b = batch.num0.shape[0]
    F0, F1 = feats[:b].contiguous(), feats[b:].contiguous()
    num0, num1 = batch.num0.tolist(), batch.num1.tolist()
    if not torch.equal(knn.nn1_mma_batched(F0, F1, knn.pair_counts(num0, num1, "cuda"))[0],
                       idx):
        fail("tail chain: the hit probe's indices differ from nn1_mma_batched's")
    r["probe_max_abs_err"] = check_nn1_batched(knn, F0, F1, num0, num1,
                                               "tail hit probe")["max_abs_err"]
    r["probe_timing"] = time_nn1_batched(knn, F0, F1, num0, num1, "tail hit probe")
    r["probe_hit_ratio_again"] = e2e.hit_ratio(
        batch, idx, config.voxel_size * config.positive_pair_search_voxel_size_multiplier)
    r["out"] = out
    return r


def _tail_tsdf(tmp: Path) -> dict:
    """(b) the TSDF tool at its default 1 cm over 6 x 6 x 4 m (the CLI, then
    the volume frame by frame for ms a frame and peak memory), and on a cut
    volume the card against the port's own CPU run."""
    from deepglobalregistration_tpu_torch.utils import integration

    depths, poses, K = room_depth_sequence()
    ddir = tmp / "depth"
    ddir.mkdir()
    for i, d in enumerate(depths):
        np.save(ddir / f"{i:03d}.npy", d)
    np.savez(tmp / "poses.npz", poses=poses)
    np.save(tmp / "K.npy", K)
    torch.cuda.synchronize()
    t0 = time.time()
    pcd = integration.main(["--depth_dir", str(ddir), "--pose_file", str(tmp / "poses.npz"),
                            "--intrinsics", str(tmp / "K.npy"),
                            "--out", str(tmp / "fragment.npz")])
    cli_s = time.time() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vol = integration.TSDFVolume(origin=np.asarray((-3, -3, 0), np.float32),
                                 voxel_size=0.01, dims=(600, 600, 400), sdf_trunc=0.04,
                                 device="cuda")
    ms = []
    for d, pose in zip(depths, poses):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol.integrate(d, K, np.linalg.inv(pose))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    pts = vol.extract_point_cloud()
    extract_ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    observed = int((vol.weight > 0).sum())
    del vol
    torch.cuda.empty_cache()

    vols = {}
    for dev in ("cuda", "cpu"):
        lo, hi, vs = TSDF_CUT["bbox_min"], TSDF_CUT["bbox_max"], TSDF_CUT["voxel_size"]
        vols[dev] = integration.TSDFVolume(
            origin=np.asarray(lo, np.float32), voxel_size=vs,
            dims=tuple(int(np.ceil((b - a) / vs)) for a, b in zip(lo, hi)),
            sdf_trunc=0.04, device=dev)
        for d, pose in zip(depths, poses):
            vols[dev].integrate(d, K, np.linalg.inv(pose))
    gap = {k: float((getattr(vols["cuda"], k).cpu() - getattr(vols["cpu"], k)).abs().max())
           for k in ("tsdf", "weight")}
    p_card, p_cpu = vols["cuda"].extract_point_cloud(), vols["cpu"].extract_point_cloud()
    r = {"frames": len(depths), "image": list(depths[0].shape), "dims": [600, 600, 400],
         "voxels": 600 * 600 * 400, "ms_per_frame_median": float(np.median(ms)),
         "ms_per_frame": ms, "extract_ms": extract_ms, "peak_mem_gib": peak,
         "observed_voxels": observed, "points": len(pts), "cli_s": cli_s,
         "cli_points": len(pcd), "cut": {**TSDF_CUT, "gap": gap, "tol": TSDF_CARD_CPU_TOL,
                                         "points_card": len(p_card),
                                         "points_cpu": len(p_cpu)}}
    print(json.dumps({"tail_tsdf": r}), flush=True)
    if len(pts) < 10000 or len(pcd) != len(pts):
        fail(f"tail TSDF: {len(pts)} points at the default volume, {len(pcd)} "
             "through the CLI")
    if max(gap.values()) > TSDF_CARD_CPU_TOL or not np.array_equal(p_card, p_cpu) \
            or len(p_cpu) < 1000:
        fail(f"tail TSDF: card vs CPU gaps {gap}, points {len(p_card)} / {len(p_cpu)}")
    return r


def _tail_profiler(bench_pair) -> dict:
    """(c) ``utils/profiling.trace`` around one bench register(): the kernel
    table must name both 1-NN kernels, and the line attribution must put
    time on lines of the port."""
    import tempfile

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.utils import profiling

    dgr = DeepGlobalRegistration(default_config(bf16=True, **BENCH), device="cuda")
    dgr.register(bench_pair[0], bench_pair[1])  # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            dgr.register(bench_pair[0], bench_pair[1])
            torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels = profiling.summarize_trace(tmp, top=10 ** 6)
        by_line = profiling.attribute_trace(tmp, top=10 ** 6, by="line")
        by_op = profiling.attribute_trace(tmp, top=10, by="op")
        parse_s = time.perf_counter() - t0
    total = sum(kernels.values())
    pkg = {k: v for k, v in by_line.items()
           if k.startswith("deepglobalregistration_tpu_torch/")}
    nn1 = {name: sum(v for k, v in kernels.items() if tag in k)
           for name, tag in NN1_KERNELS.items()}
    r = {"traced_s": trace_s, "parse_s": parse_s, "kernel_ms": total,
         "nn1_kernel_ms": nn1, "package_line_ms": sum(pkg.values()),
         "top_kernels_ms": dict(list(kernels.items())[:8]),
         "top_lines_ms": dict(list(by_line.items())[:10]), "top_ops_ms": by_op}
    print(json.dumps({"tail_profiler": r}), flush=True)
    if not all(v > 0 for v in nn1.values()):
        fail(f"tail profiler: the trace does not name both 1-NN kernels: {nn1}")
    if not pkg or sum(pkg.values()) <= 0:
        fail("tail profiler: no kernel time on a line of the port")
    return r


def _tail_tools(tmp: Path, chain_out: Path, bench_pair) -> dict:
    """(d) export_bench_weights on stage A's checkpoint, loaded by
    DeepGlobalRegistration; golden_fcgf on the committed weights against a
    golden npz of their own identity-order features; ransac_sweep at two
    trials a budget."""
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.tools import (export_bench_weights,
                                                        golden_fcgf, ransac_sweep)

    r = {}
    exported = tmp / "bench_fcgf.pkl"
    export_bench_weights.main(["--ckpt", str(chain_out / "fcgf_selftrained.pkl"),
                               "--out", str(exported)])
    dgr = DeepGlobalRegistration(default_config(**dict(BENCH, weights=str(exported))),
                                 device="cuda")
    T = dgr.register(bench_pair[0], bench_pair[1])
    r["export"] = {"mib": exported.stat().st_size / 2 ** 20, "pose_finite":
                   bool(np.isfinite(T).all()), "voxel_size": dgr.voxel_size}
    if not np.isfinite(T).all():
        fail("tail tools: register() from the exported weights gave a non-finite pose")

    spec, cfg, params, state, _ = golden_fcgf.load_fcgf(str(WEIGHTS))
    xyz = (np.random.RandomState(0).rand(5000, 3) * 3.0).astype(np.float32)
    feats, coords = golden_fcgf.run_fcgf(spec, cfg, params, state, xyz, 0.05, "cuda")
    np.savez(tmp / "golden.npz", xyz=xyz, feats=feats, coords=coords)
    t0 = time.time()
    res = golden_fcgf.main(["--weights", str(WEIGHTS), "--golden", str(tmp / "golden.npz")])
    r["golden"] = {"s": time.time() - t0, **res}
    if [n for n, v in res.items() if v["pass"]] != ["identity"]:
        fail(f"tail tools: golden_fcgf verdict {res}")

    t0 = time.time()
    res = ransac_sweep.main(["--trials", "2"])
    r["ransac_sweep"] = {"s": time.time() - t0, **res}
    print(json.dumps({"tail_tools": r}), flush=True)
    # At a 0.2 inlier ratio a 4096-hypothesis budget draws a clean sample
    # with probability 0.999.
    if not all(v["recall"] == 1.0 for v in res.values()
               if v["inlier_ratio"] >= 0.2 and v["hypotheses"] >= 4096):
        fail("tail tools: ransac_sweep missed a pair at inlier ratio 0.2")
    return r


def phase_tail(knn, bench_pair) -> dict:
    """The tail (15): (a) the chain, (b) TSDF, (c) the profiler, (d) the tools."""
    import tempfile

    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        chain = _tail_chain(knn, tmp)
        torch.cuda.empty_cache()
        tsdf = _tail_tsdf(tmp)
        prof = _tail_profiler(bench_pair)
        tools = _tail_tools(tmp, chain.pop("out"), bench_pair)
    torch.cuda.empty_cache()
    print(f"tail: {time.time() - t0:.1f} s", flush=True)
    return {"chain": chain, "tsdf": tsdf, "profiler": prof, "tools": tools}


def chain_full(argv) -> int:
    """``python3 chip_smoke.py --chain [--keep DIR] [synthetic_e2e flags]``: the chain at
    full size on the card (run alone, not by the default smoke), then each
    stage's 1-NN launch timed at its own shapes, and with ``--profile lidar``
    register()'s ICP stage with icp_candidates "auto" and "off" in turns on
    the KITTI-scale pairs from the trained checkpoint. The run's
    summary.json, scalars, stats and ``chain_kernels.json`` go to
    ``<keep>/e2e_<profile>/`` (``--keep DIR`` before the chain's flags,
    default ``outputs``); the checkpoints stay in a temporary directory."""
    import shutil
    import tempfile

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core import train_step as ts
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.data.factory import make_data_loader
    from deepglobalregistration_tpu_torch.ops import knn, se3
    from deepglobalregistration_tpu_torch.tools import synthetic_e2e as e2e
    from deepglobalregistration_tpu_torch.utils import checkpoint, convert, cuda_build, device
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    device.set_precision()
    cuda_build.build()
    print(card_line(), flush=True)
    keep_dir = "outputs"
    if argv[:1] == ["--keep"]:
        keep_dir, argv = argv[1], argv[2:]
    args = e2e.parse_args(argv)
    keep = ROOT / keep_dir / f"e2e_{args.profile}"
    tmp = tempfile.mkdtemp()
    if "--out_dir" not in argv:
        argv = argv + ["--out_dir", tmp]
        args = e2e.parse_args(argv)
    out = Path(args.out_dir)
    summary = e2e.main(argv)
    keep.mkdir(parents=True, exist_ok=True)
    for f in ("summary.json", "scalars.jsonl", "config.json", "3dmatch-stats.npz",
              "kitti-stats.npz"):
        if (out / f).exists():
            shutil.copy(out / f, keep / f)

    config, run = e2e.build_config(args)
    fcgf_ckpt = args.skip_a or str(out / "fcgf_selftrained.pkl")
    best = args.skip_b or str(out / "best_val_checkpoint.pkl")
    net = e2e.fcgf_net(config, "cuda")
    sd = checkpoint.load_checkpoint(fcgf_ckpt)["state_dict"]
    net.load_state_dict(convert.from_jax_params(sd["params"], sd["state"], net.cfg))
    rows = {}
    for label, phase in (("probe", "val"), ("train_match", "train")):
        batch = ts.batch_to(next(iter(make_data_loader(config, phase, config.batch_size)))
                            ["pair_batch"], "cuda")
        feats, idx = e2e.probe_match(net, batch)
        b = batch.num0.shape[0]
        F0, F1 = feats[:b].contiguous(), feats[b:].contiguous()
        num0, num1 = batch.num0.tolist(), batch.num1.tolist()
        err = check_nn1_batched(knn, F0, F1, num0, num1, f"chain {label}")["max_abs_err"]
        rows[label] = dict(time_nn1_batched(knn, F0, F1, num0, num1, f"chain {label}"),
                           max_abs_err=err, bucket=int(F0.shape[1]))
    del net, feats, F0, F1
    config.weights = best
    dgr = DeepGlobalRegistration(config, device="cuda")
    if run.lidar:
        item = next(iter(make_data_loader(config, "test", 1, shuffle=False)))
        pair = (item["pcd0"][0], item["pcd1"][0])
    else:
        from deepglobalregistration_tpu_torch.data.synthetic import SyntheticTrajectoryDataset

        _, x0, x1, _ = SyntheticTrajectoryDataset(n_points=run.n_points)[0]
        pair = (x0, x1)
    T = dgr.register(*pair)
    x0, x1 = dgr._as_tensor(pair[0]), dgr._as_tensor(pair[1])
    with torch.no_grad():
        sel0, sel1, _, _, a0, a1, _ = dgr.features(x0, x1)
    moved = se3.apply_transform(sel0, torch.as_tensor(T, dtype=torch.float32,
                                                      device="cuda"))
    rows["eval_match"] = time_nn1(knn, a0, a1, "chain eval feature match (pair 0)")
    rows["eval_scan"] = time_nn1(knn, moved.contiguous(), sel1,
                                 "chain eval ICP scan (pair 0)", bitwise=True)
    r = {"profile": args.profile, "card": card_line(), "summary": summary,
         "kernels": rows}
    if run.lidar:
        # Section 2 item C: the KITTI-scale pairs with the trained weights.
        del dgr
        torch.cuda.empty_cache()
        dgr = DeepGlobalRegistration(default_config(bf16=True, **dict(KITTI, weights=best)),
                                     device="cuda")
        pairs = []
        for seed in range(3):
            xyz0, xyz1, R, t = lidar_like_pair(seed=seed)
            T_gt = np.eye(4, dtype=np.float32)
            T_gt[:3, :3], T_gt[:3, 3] = R, t
            pairs.append((xyz0, xyz1, T_gt))
        dgr.register(pairs[0][0], pairs[0][1])  # warm-up
        # ROADMAP section 3 item 2: nn1_mma on trained features at KITTI
        # scale, without the allowance random features need for dense ties.
        r["trained_match"] = []
        for k, (xyz0, xyz1, _) in enumerate(pairs):
            with torch.no_grad():
                _, _, _, _, a0, a1, _ = dgr.features(dgr._as_tensor(xyz0),
                                                     dgr._as_tensor(xyz1))
            r["trained_match"].append(check_nn1(
                knn, a0, a1, a0.shape[0], a1.shape[0], False,
                f"trained lidar KITTI-scale match, pair {k}", dense_ties=False))
        dgr.stage_timers["icp"].reset()
        modes, errs, falls = [], [], []
        for xyz0, xyz1, T_gt in pairs:
            before = dgr.cand_fallbacks
            errs.append(pose_errors(dgr.register(xyz0, xyz1), T_gt))
            modes.append(dgr.last_iterations.get("icp_mode"))
            falls.append(dgr.cand_fallbacks - before)
        torch.cuda.synchronize()
        # In turns: auto, off, auto, off, auto.
        first = icp_auto_vs_off(dgr, pairs, dgr.stage_timers["icp"].avg)
        second = icp_auto_vs_off(dgr, pairs, first["icp_auto_s_per_pair"][-1])
        r["icp_auto_vs_off"] = {"turns": [first, second], "icp_mode_per_pair": modes,
                                "cand_fallbacks_per_pair": falls,
                                "rre_deg_per_pair": [e[0] for e in errs],
                                "rte_m_per_pair": [e[1] for e in errs],
                                "inlier_trained": dgr.inlier_trained}
    (keep / "chain_kernels.json").write_text(json.dumps(r, indent=1, default=str))
    print(json.dumps({"chain_full": r}, default=str), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _tree_leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 2
    if not (ROOT / "deepglobalregistration_tpu_torch").is_dir():
        print("FAIL: the port's package is not beside chip_smoke.py", flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--chain"]:
        return chain_full(sys.argv[2:])
    if sys.argv[1:2] == ["--deterministic-stream"]:
        return deterministic_stream()
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
    ev = phase_eval(knn, e["pairs"], e["Ts"])
    tr = phase_train(knn)
    par = phase_parallel(knn)
    tail = phase_tail(knn, e["pairs"][0])
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
            ("pth", models["pth_launches"]), ("eval_demo", ev["demo"]),
            ("eval_3dmatch", ev["3dmatch"]), ("eval_kitti", ev["kitti"]),
            ("tail_chain", tail["chain"]["launches"]),
            ("register_many", batch["launches_many"]))})
        if name == "nn1_scan":  # the KITTI loader's ground-truth ICP
            g = ev["kitti_gt_timing"]
            entry.update({f"{k}_kitti_gt": g[k] for k in (
                "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "near_ties", "max_err_of_tolerance", "shape")})
            entry["launches_kitti_gt"] = ev["kitti_gt"]["nn1_scan"]
            entry["max_abs_err"] = max(entry["max_abs_err"], g["max_abs_err"])
            entry["shape"] += (f"; *_kitti_gt: KITTI loader ground-truth ICP scan "
                               f"{g['shape']}")
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
                 "launches_kitti": batch_kitti["launches"][name],
                 "launches_parallel_train": sum(
                     step[name] for rank in par["train"]["launches_per_rank"]
                     for step in rank),
                 "launches_parallel_fanout": sum(
                     lc[name] for lc in par["fanout"]["launches_per_rank"]),
                 "launches_tail_chain": tail["chain"]["launches"][name]}
        if name == "nn1_mma_batched":
            k = batch_kitti["timing"]
            entry.update({f"{key}_kitti": k[key] for key in (
                "ms", "unbatched_sum_ms", "plain_ms", "library_ms", "bound_ms")})
            t = tr["timing"]  # the train step's feature match
            entry.update({f"{key}_train": t[key] for key in (
                "ms", "unbatched_sum_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "shape")})
            entry["bound_f32_ms_train"], _ = nn1_bound_ms(
                tr["num0"], tr["num1"], 32)
            entry["launches_train"] = tr["launches"][name]
            entry["launches_train_main"] = tr["trainer"]["launches"][name]
            entry["max_abs_err"] = max(entry["max_abs_err"], tr["max_abs_err"],
                                       *par["train"]["match_max_abs_err_ranks"],
                                       tail["chain"]["probe_max_abs_err"])
            p = tail["chain"]["probe_timing"]  # the chain's hit probe
            entry.update({f"{key}_tail_probe": p[key] for key in (
                "ms", "unbatched_sum_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "shape")})
        entries.append(entry)
    slot = e["slot"]
    slot_runs = [c for c in slot["cases"] if c["kind"] == "dk"]
    for name, cases, launches, path, replaces, library_call in (
            ("slot_sum", [c for c in slot["cases"] if c["kind"] != "dk"],
             e["slot_launches"]["slot_sum"], "register() on the 4 bench pairs (phase 4)",
             "deepglobalregistration_tpu/ops/edge_conv.py:557",
             "out.index_add_(0, dst, P): each product added at its output row"),
            ("slot_sum_runs", slot_runs, tr["slot_launches"]["slot_sum_runs"],
             "one train step (phase 13 b): every conv backward's kernel gradient",
             "deepglobalregistration_tpu/ops/edge_conv.py:662",
             "dk.index_add_(0, tile_k, P): each tile's g^T dy added at its offset"),
            ("slot_sum_rows", slot["rows_cases"], models["slot_launches"]["slot_sum_rows"],
             "the 47 registry forwards, 11 calls each (phase 11 a): the SP "
             "families' sum pooling", "deepglobalregistration_tpu/ops/edge_conv.py:557",
             "out.index_add_(0, dst, x.index_select(0, rows))")):
        head = cases[0]
        entries.append({
            "name": name, "route": "cuda",
            "source": "deepglobalregistration_tpu_torch/csrc/slot_sum.cu",
            "replaces": replaces,
            "launches": launches, "launches_path": path,
            "launches_models": models["slot_launches"][name],
            "launches_train_step": tr["slot_launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: head[k] for k in ("ms", "eager_ms", "cold_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "library_deterministic_ms")},
            "shape": head["case"],
            "library_call": library_call,
            "cases": [{k: c[k] for k in ("case", "ms", "eager_ms", "cold_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms",
                                         "library_deterministic_ms")}
                      for c in cases]})
    print(json.dumps({"kernels": entries + gather_entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
