"""The readings the correctness limits are set from: a cell's compared
numbers over many seeds, and its control's on the same sampled answers.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ... \\
        --seconds 3 [--control 3]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check) in this one process; ``--control n`` also reads the controls
on the first ``n`` seeds: a whole run of the program with its own
lower-precision path switched on (``pyramid_precision`` FLOAT16, judged
like the program) and the reference's 2-NN on 4-bit descriptors in the
program's place. One JSON line a seed. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        bench_run.fail("no CUDA device")
    parts = bench_run.load(args.workload)
    for k, seed in enumerate(args.seeds):
        out = bench_run.measure(**parts, seed=seed, seconds=args.seconds,
                                trace=False, control=k < args.control)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["result"]["correct"], "why": out["why"],
                "numbers": out["numbers"], "control": out.get("control"),
                "metrics": out["result"]["metrics"]}
        if k < args.control and parts["traffic"]["check"]["detect_items"]:
            ctl = bench_run.measure(
                **dict(parts, cfg_file=bench_run.control_config(
                    parts["cfg_file"])),
                seed=seed, seconds=args.seconds, trace=False)
            line["control_program"] = {"correct": ctl["result"]["correct"],
                                       "why": ctl["why"],
                                       "numbers": ctl["numbers"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
