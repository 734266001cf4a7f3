"""The benchmark harness: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name (see README.md):
  BENCHMARK.json                     the cells and the metrics
  benchmark/configs/<config>.json    a configuration, as the program runs it
  benchmark/traffic/<traffic>.json   a traffic mix; its "driver" names the window driver
  benchmark/drivers/<driver>.py      a window driver (class Driver)
  benchmark/limits/<cell>.json       the limits of the cell's output comparison
  benchmark/metrics/<metric>.py      a per-layer metric's reader (def read(run))

A run: the window driver builds the program and its inputs from the seed
and warms up the cell's shapes (set-up), measures for `--seconds`, and with
`--trace 1` profiles a short window after it; the program's device memory
peak is read and its state freed; the window driver then compares what the
timed path produced with the plain reference.  The last line of standard
output is the result; the numbers compared are the last lines of standard
error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
# modules that may not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "fddm_asr_tpu")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at `path` as a module of its own."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def passes(value, limit) -> bool:
    """A number compared passes when it is at most its limit; a missing
    number or limit fails."""
    return value is not None and limit is not None and value <= limit


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A cell of the manifest with the files it names."""

    def __init__(self, manifest: dict, name: str, bench_dir: str = BENCH):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        self.name, self.chips, self.bench_dir = name, int(w["chips"]), bench_dir
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(os.path.join(os.path.dirname(bench_dir),
                                             configs[w["config"]]["file"]))
        self.traffic = load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
        limits_path = os.path.join(bench_dir, "limits", name + ".json")
        self.limits = load_json(limits_path)["limits"] if os.path.exists(limits_path) else {}
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def driver(self):
        path = os.path.join(self.bench_dir, "drivers", self.traffic["driver"] + ".py")
        return load_module(path, "bench_driver_" + self.traffic["driver"])

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        return load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


class Run:
    """What one run knows: the cell, the seed, the device, and what the
    driver and the trace record for the readers (`spans`: host seconds by
    name; `window`: the measured window's totals; `trace`: trace.summarize's
    reduction; `kernel_work`: a hand kernel's operations, bytes and
    launches in the traced window)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 workdir: str, variant: Optional[str] = None):
        import counters

        self.cell, self.seed, self.seconds, self.trace_on = cell, int(seed), float(seconds), trace
        self.device, self.workdir, self.variant = device, workdir, variant
        self.spans: Dict[str, List[float]] = {}
        self.window: dict = {}
        self.trace: Optional[dict] = None
        self.kernel_work: Dict[str, dict] = {}
        self.notes: Dict[str, object] = {}
        self.peaks = counters.peaks()
        self.t_start = time.perf_counter()

    def mark(self, name: str) -> None:
        """Note the seconds from the process's start to a step of set-up."""
        self.notes.setdefault("setup_marks", {})[name] = time.perf_counter() - self.t_start

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def _synchronize(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, workdir: str,
             t_start: float, variant: Optional[str] = None) -> tuple:
    """One run; returns (result dict, [(name, value, limit)] compared)."""
    import torch

    import tracing as tr

    run = Run(cell, seed, seconds, trace, device, workdir, variant)
    run.t_start = t_start
    driver = cell.driver().Driver(run)
    driver.setup()
    _synchronize(device)
    # set-up's garbage collected before the window opens; nothing is frozen,
    # so the window's collections scan what a user's process would
    gc.collect()
    setup_s = time.perf_counter() - t_start
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    e2e = driver.window(seconds)
    e2e["setup_s"] = setup_s
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            driver.traced()
            _synchronize(device)
            traced_s = time.perf_counter() - t0
        run.trace = tr.summarize(prof, traced_s, driver.RANGES)
        del prof
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    driver.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    compared = driver.check()
    correct = bool(compared) and all(passes(value, limit) for _, value, limit in compared)

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if trace:
            got = cell.reader(m["name"]).read(run)
            if got is None:
                continue
            value = got["value"] if isinstance(got, dict) else got
            if isinstance(got, dict) and "note" in got:
                run.notes[m["name"]] = got["note"]
        else:
            value = e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"the window driver gave no {m['name']}")
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.window.get("attempted", 0)),
              "failed": int(run.window.get("failed", 0)), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["notes"] = run.notes
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in compared}
    return result, compared


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", default=None,
                   help="a named change from the configuration's 'variants' (the comparison's "
                        "control); never used by the benchmark's own runs")
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    root = os.path.dirname(BENCH)
    manifest_path = os.path.join(root, "BENCHMARK.json")
    manifest = load_json(manifest_path)
    cell = Cell(manifest, args.workload)
    cache_dirs(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    workdir = os.environ.get("TMPDIR") or os.path.join(root, "benchmark", ".cache", "tmp")
    os.makedirs(workdir, exist_ok=True)
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                workdir, t_start, args.variant)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules were loaded: {found}", file=sys.stderr)
        return 4
    limit = _power_limit()
    if limit:
        result["notes"]["card"] = limit
        result["checks"] = result.pop("checks")
        print(f"card: {limit}", file=sys.stderr)
    for name, value, lim in compared:
        print(f"check {name} {value!r} limit {lim!r} "
              f"{'ok' if passes(value, lim) else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
