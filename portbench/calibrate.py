"""Readings for the limits of ``correct``, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

For each ``--seeds`` seed, one run of the cell as the benchmark makes it
(set-up, a window of ``--seconds`` at the cell's own load, the check); for
each ``--control-seeds`` seed, the same with the reference put in the
program's place at the precision below the configuration's (TF32; see
``portbench/ref/chain.py``). Prints one JSON line a run with the numbers
compared. The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from portbench import bench

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    device = torch.device("cuda", 0)
    resolved = bench.resolve(bench.load_spec(), args.workload)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            res = bench.run_cell(resolved, seed, args.seconds, False, t0, device, control=control)
            print(json.dumps({
                "workload": args.workload, "control": control, "seed": seed,
                "attempted": res["attempted"], "failed": res["failed"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "peak": res["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0,
            }), flush=True)
