"""The runs that set a cell's bounds: sets of runs of the benchmark's own
command, one process a run, and the spread of each metric.

    python3 portbench/measure.py --workload <cell> --seconds <s> \\
        --sets 2 --seeds <n> ... [--trace 0|1] [--out <dir>]

Each set runs the cell once per seed, in the order given (the same seeds
in every set). Prints one line a run, then for each metric and set its
median and spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median. With
``--out``, each run's standard output and error are kept there.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med, statistics.median(values)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args()
    root = os.path.dirname(HERE)
    runs = []
    for k in range(args.sets):
        for seed in args.seeds:
            cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            res = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                stem = os.path.join(args.out, f"{args.workload}.t{args.trace}.set{k}.{seed}")
                for ext, text in (("out", res.stdout), ("err", res.stderr)):
                    with open(f"{stem}.{ext}", "w") as f:
                        f.write(text)
            try:
                line = json.loads(res.stdout.strip().splitlines()[-1])
            except (IndexError, json.JSONDecodeError):
                print(json.dumps({"set": k, "seed": seed, "rc": res.returncode, "stderr": res.stderr[-2000:]}), flush=True)
                continue
            row = {"set": k, "seed": seed, "rc": res.returncode, "correct": line["correct"],
                   "attempted": line["attempted"], "failed": line["failed"],
                   "metrics": {m: v["value"] for m, v in line["metrics"].items()},
                   "checks": {c: v["value"] for c, v in line["checks"].items()},
                   "peak": line["device"]["memory_peak_bytes"]}
            for key in ("busy_s", "window_s"):
                if key in line["device"]:
                    row[key] = line["device"][key]
            if "breakdown" in line:
                row["breakdown"] = line["breakdown"]
            runs.append(row)
            print(json.dumps(row), flush=True)
    names = sorted({m for r in runs for m in r["metrics"]})
    for m in names:
        for k in range(args.sets):
            vals = [r["metrics"][m] for r in runs if r["set"] == k and m in r["metrics"]]
            if len(vals) >= 2:
                s, med = spread(vals)
                print(f"{args.workload} {m} set {k}: median {med!r} spread {s!r} n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
