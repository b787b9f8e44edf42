"""Benchmark stats analysis (a copy of the repo's ``scripts/analyze_stats.py``;
reference scripts/analyze_stats.py:78-273).

Consumes the npz stats schema ``(num_methods, num_pairs, 5 = [succ, rte, rre,
time, scene_id])``, prints recall/TE/RE tables, and (when matplotlib is
available) renders recall bars, precision-style recall-vs-threshold curves and
the speed-vs-recall Pareto frontier.

Reads the npz that the port's ``scripts/test_3dmatch.py`` and
``scripts/test_kitti.py`` write. numpy only; matplotlib when it imports.

Run: python -m deepglobalregistration_tpu_torch.scripts.analyze_stats outputs/3dmatch-stats.npz
"""

import sys

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAS_MPL = True
except Exception:  # matplotlib not in the image: tables only
    HAS_MPL = False


def summarize(stats: np.ndarray, names):
    print(f"{'method':<24} {'recall':>8} {'TE (m)':>8} {'RE (deg)':>9} {'time (s)':>9}")
    for i, name in enumerate(names):
        s = stats[i]
        succ = s[:, 0] > 0
        te = s[succ, 1].mean() if succ.any() else np.nan
        re = s[succ, 2].mean() if succ.any() else np.nan
        print(f"{str(name):<24} {succ.mean():>8.4f} {te:>8.4f} {re:>9.4f} "
              f"{s[:, 3].mean():>9.3f}")


def recall_curves(stats: np.ndarray, names, rte_grid=None, rre_grid=None):
    """Recall as a function of RTE/RRE thresholds (analyze_stats.py PR curves)."""
    rte_grid = rte_grid if rte_grid is not None else np.linspace(0.0, 0.6, 61)
    rre_grid = rre_grid if rre_grid is not None else np.linspace(0.0, 30.0, 61)
    curves = {}
    for i, name in enumerate(names):
        s = stats[i]
        rte_recall = [(s[:, 1] < t).mean() for t in rte_grid]
        rre_recall = [(s[:, 2] < t).mean() for t in rre_grid]
        curves[str(name)] = (np.asarray(rte_recall), np.asarray(rre_recall))
    return rte_grid, rre_grid, curves


def plot_all(stats, names, prefix="stats"):
    if not HAS_MPL:
        print("(matplotlib unavailable: skipping figures)")
        return
    recalls = [(stats[i][:, 0] > 0).mean() for i in range(len(names))]
    times = [stats[i][:, 3].mean() for i in range(len(names))]

    fig, ax = plt.subplots()
    ax.bar(range(len(names)), recalls)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels([str(n) for n in names], rotation=45, ha="right")
    ax.set_ylabel("recall")
    fig.tight_layout()
    fig.savefig(f"{prefix}_recall.png", dpi=150)

    rte_grid, rre_grid, curves = recall_curves(stats, names)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for name, (rte_c, rre_c) in curves.items():
        axes[0].plot(rte_grid, rte_c, label=name)
        axes[1].plot(rre_grid, rre_c, label=name)
    axes[0].set_xlabel("RTE threshold (m)")
    axes[1].set_xlabel("RRE threshold (deg)")
    axes[0].set_ylabel("recall")
    axes[0].legend()
    fig.tight_layout()
    fig.savefig(f"{prefix}_curves.png", dpi=150)

    fig, ax = plt.subplots()
    ax.scatter([1.0 / max(t, 1e-9) for t in times], recalls)
    for x, y, n in zip([1.0 / max(t, 1e-9) for t in times], recalls, names):
        ax.annotate(str(n), (x, y))
    ax.set_xlabel("registrations / s")
    ax.set_ylabel("recall")
    ax.set_xscale("log")
    fig.tight_layout()
    fig.savefig(f"{prefix}_frontier.png", dpi=150)
    print(f"wrote {prefix}_recall.png {prefix}_curves.png {prefix}_frontier.png")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "outputs/3dmatch-stats.npz"
    data = np.load(path, allow_pickle=True)
    stats = data["stats"]
    names = data["names"] if "names" in data else [f"method{i}" for i in range(len(stats))]
    summarize(stats, names)
    plot_all(stats, names, prefix=path.rsplit(".", 1)[0])


if __name__ == "__main__":
    main()
