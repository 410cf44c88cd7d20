"""Plot matching/runtime benchmark results (port of
``vulkansift_tpu/perf/plot.py``; parity: reference
scripts/plot_matching_results.py + plot_oxford_runtime_perf.py — the result
files are byte-compatible with those scripts too; this is the in-repo
equivalent so plots work without the reference tree). Needs
``matplotlib``, imported at the first plot.

Usage: python -m vulkansift_tpu_torch.perf.plot [--dir .] [--out-dir .]
"""

import argparse
import os
import sys
from collections import defaultdict


def plot_matching(result_dir: str, out_dir: str) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    files = [n for n in os.listdir(result_dir) if "matching_results" in n]
    results = defaultdict(dict)
    metrics = ["Repeatability", "Match Ratio", "Precision", "Matching score"]
    for fname in files:
        det = fname.split("matching_results_")[1].split(".txt")[0]
        with open(os.path.join(result_dir, fname)) as f:
            for line in f:
                parts = line.strip().split(";")
                if len(parts) < 7:
                    continue
                ds = parts[0]
                results[ds].setdefault(det, {m: [] for m in metrics})
                for m, v in zip(metrics, parts[3:7]):
                    results[ds][det][m].append(100.0 * float(v))
    count = 0
    for ds, dets in results.items():
        for metric in metrics:
            for det, vals in dets.items():
                ys = vals[metric]
                plt.plot(range(1, len(ys) + 1), ys, marker="o", label=det)
            plt.xlabel("Image pair")
            plt.ylabel(metric)
            plt.ylim(0, 100)
            plt.title(f"{ds} — {metric}")
            plt.legend()
            plt.savefig(os.path.join(out_dir, f"{ds}_{metric}.png"))
            plt.clf()
            count += 1
    return count


def plot_runtime(result_dir: str, out_dir: str) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    files = [n for n in os.listdir(result_dir)
             if n.startswith("oxford_runtime_points_")]
    for fname in files:
        det = fname.split("oxford_runtime_points_")[1].split(".txt")[0]
        ms, feats = [], []
        with open(os.path.join(result_dir, fname)) as f:
            for line in f:
                a, b = line.strip().split(";")
                ms.append(float(a))
                feats.append(int(b))
        plt.scatter(feats, ms, label=det, s=12)
    if files:
        plt.xlabel("# features")
        plt.ylabel("detect time (ms)")
        plt.legend()
        plt.savefig(os.path.join(out_dir, "runtime_vs_features.png"))
        plt.clf()
    return len(files)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    n1 = plot_matching(args.dir, args.out_dir)
    n2 = plot_runtime(args.dir, args.out_dir)
    print(f"wrote {n1} matching plots, {n2} runtime plots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
