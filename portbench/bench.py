"""The harness: one cell, one run, one result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness finds the rest by name:

- ``portbench/configs/<config>.json``: the deployment (stocks, settings,
  frame, sensor levels), as the cell's configuration entry names it;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the module of ``portbench/drivers/`` that runs requests of
  that kind, and the limits of the numbers that decide ``correct``;
- ``portbench/metrics/<metric>.py``: one reader per metric, end to end or
  per layer (``read(run)``; ``SPANS``, the calls it wants timed).

A run: set-up (the driver builds its inputs from the seed and warms every
shape the mix uses), a closed-loop window of ``--seconds`` (the next
request leaves when the last has completed), then, with the program's
state freed, the comparison of the window's answers with the plain
reference. ``--trace 1`` times the same window under ``torch.profiler``
with the spans the cell's per-layer metrics ask for, and reports those.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

from portbench import spans as spans_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level modules that may not be loaded in a run: JAX, and the JAX
# package the port was made from (compared whole: the port's name begins
# with it), and the JAX package's benchmarks.
FORBIDDEN = ("jax", "jaxlib", "flax", "raw2film_tpu", "benchmarks")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, bench_dir: str = HERE) -> dict:
    """The cell's entries and files, by name: its configuration and traffic
    mix, and the metrics it reports with and without a trace."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[cell["config"]]
    with open(os.path.join(os.path.dirname(bench_dir), conf_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return workload in m["workloads"] if "workloads" in m else True

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def _load(folder: str, name: str, bench_dir: str):
    """The module ``<bench_dir>/<folder>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(bench_dir, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, bench_dir: str = HERE):
    return _load("metrics", name, bench_dir)


def load_driver(name: str, bench_dir: str = HERE):
    return _load("drivers", name, bench_dir)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a metric reader sees of one run."""

    def __init__(self, cell, config, traffic, device):
        self.cell, self.config, self.traffic, self.device = cell, config, traffic, device
        self.setup_s = None
        self.window_s = None
        self.latencies_s: list[float] = []
        self.units: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.spans: dict[str, spans_mod.Span] = {}
        self.trace = None  # spans.TraceSummary of a traced window


def window(driver, run: Run, seconds: float, record=None) -> None:
    """The closed loop: requests one after another until ``seconds`` have
    passed; the window ends when the last request completes. Every
    request's latency and every unit of work it reports count."""
    t_start = time.perf_counter()
    deadline = t_start + seconds
    errors = []
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        run.attempted += 1
        try:
            if record is not None:
                with record("portbench.request"):
                    units = driver.step()
            else:
                units = driver.step()
        except Exception:  # a failed request is counted, and the run is not correct
            run.failed += 1
            errors.append(traceback.format_exc())
            continue
        run.latencies_s.append(time.perf_counter() - t)
        for k, v in units.items():
            run.units[k] = run.units.get(k, 0.0) + v
    run.window_s = time.perf_counter() - t_start
    for e in errors[:3]:
        print(e, file=sys.stderr)


def run_cell(resolved: dict, seed: int, seconds: float, trace: bool, t0: float, device,
             bench_dir: str = HERE, control: bool = False) -> dict:
    """Set-up, window and check of one cell on ``device``: the result's
    keys. ``control`` puts the reference in the program's place (the
    control of the ``correct`` check), which a benchmark run never does."""
    import torch

    cell, config, traffic = resolved["cell"], resolved["config"], resolved["traffic"]
    run = Run(cell, config, traffic, device)
    driver_mod = load_driver(traffic["driver"], bench_dir)
    metrics = resolved["per_layer"] if trace else resolved["end_to_end"]
    readers = {m["name"]: load_metric(m["name"], bench_dir) for m in metrics}
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    driver = driver_mod.Driver(config, traffic, seed, device, control=control)
    if on_cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0

    installed = []
    if trace:
        wanted = {}
        for r in readers.values():
            wanted.update(getattr(r, "SPANS", {}))
        run.spans, installed = spans_mod.install(wanted, on_cuda)
    try:
        if trace:
            with spans_mod.Profiled(on_cuda) as prof:
                window(driver, run, seconds, record=spans_mod.record)
            run.trace = prof.summary()
        else:
            window(driver, run, seconds)
    finally:
        spans_mod.uninstall(installed)
    if on_cuda:
        torch.cuda.synchronize()
    for s in run.spans.values():
        s.finish()
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    driver.release()
    checks = driver.check()
    limits = traffic["limits"]
    compared = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    result = {
        "correct": bool(correct),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": peak,
        },
    }
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = compared
    return result


def print_checks(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    resolved = resolve(load_spec(), args.workload)
    import torch

    chips = int(resolved["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(resolved, args.seed, args.seconds, bool(args.trace), t0, torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 4
    print_checks(result)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
