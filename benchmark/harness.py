"""The benchmark's machinery, shared by every cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Everything belonging to one of them is a
file found by its name:

* ``configs/<config>.json``: the model's sizes;
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  driver, ``drivers/<kind>.py``, that generates and runs it;
* ``workloads/<cell>.json`` (optional): parameters of that cell alone, laid
  over the traffic's (a serving rate, the limits of its comparisons);
* ``metrics/<metric>.py``, or ``metrics/<quantity>.py`` for a metric named
  ``<quantity>.<suffix>``: the reader of one per-layer metric, ``read(run)``
  -> a number or None when the run holds nothing to read.

A driver builds the program's timed path, warms it, measures inside
``run.window()`` and then compares what the window produced with the plain
reference (``run.check``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may load (compared whole: the program,
# ``crosstalk_tpu_torch``, starts with the letters of the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "crosstalk_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.params["kind"]


def load_cell(name: str, bench: Optional[dict] = None, base: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    params = load_json(base / "traffic" / f"{w['traffic']}.json")
    own = base / "workloads" / f"{name}.json"
    if own.exists():
        params = {**params, **load_json(own)}
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), w["config"],
                load_json(base / "configs" / f"{w['config']}.json"),
                w["traffic"], params, e2e, per_layer)


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = BENCH_DIR):
    """The ``read(run)`` function of a per-layer metric."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(path).read
    raise FileNotFoundError(f"no reader for metric {metric!r} in {base / 'metrics'}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Trace:
    """What the profiler saw of the window."""

    busy_s: float
    window_s: float
    kernels: Dict[str, List[float]]  # device op name -> [seconds, count]
    idle_gaps: Dict[str, float]      # host op during a device gap -> seconds

    def top_ops(self, n: int = 10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k[:160], v[0]] for k, v in ops]

    def top_gaps(self, n: int = 10):
        return [[k[:160], v] for k, v in
                sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:n]]


def summarize_trace(prof, t0_ns: int, t1_ns: int) -> Trace:
    """Device busy time, time by device op and idle time by host op, from a
    ``torch.profiler`` session over [t0_ns, t1_ns] (wall clock ns)."""
    import numpy as np

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        s, d = e.start_ns(), e.duration_ns()
        if kind == "CUDA":
            dev.append((s, s + d, e.name()))
        elif kind == "CPU" and d > 0:
            host.append((s, s + d, e.name()))
    kernels: Dict[str, List[float]] = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (min(t, t1_ns) - max(s, t0_ns)) / 1e9 if t > t0_ns and s < t1_ns else 0.0
        k[1] += 1
    spans = sorted((max(s, t0_ns), min(t, t1_ns)) for s, t, _ in dev
                   if t > t0_ns and s < t1_ns)
    busy, gaps, end = 0, [], t0_ns
    for s, t in spans:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if t1_ns > end:
        gaps.append((end, t1_ns))
    idle: Dict[str, float] = {}
    if gaps:
        host.sort()
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:4000]
        for a, b in longest:
            mid = (a + b) // 2
            i = int(np.searchsorted(hs, mid, side="right"))
            lo = max(0, i - 4000)
            cover = np.nonzero(he[lo:i] >= mid)[0]
            if cover.size:
                name = host[lo + cover[-1]][2]
            elif i < len(host):
                name = f"host Python, then {host[i][2]}"
            else:
                name = "host Python"
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        rest = sum(b - a for a, b in gaps) / 1e9 - sum(idle.values())
        if rest > 0:
            idle["shorter gaps, not attributed"] = rest
    return Trace(busy / 1e9, (t1_ns - t0_ns) / 1e9, kernels, idle)


class Window:
    """The measured window: set-up ends when it opens; with tracing on, the
    profiler records exactly this span."""

    def __init__(self, run: "Run"):
        self.run = run
        self.t0 = self.t1 = None

    def __enter__(self) -> "Window":
        r = self.run
        r.sync()
        r.setup_s = time.monotonic() - r.t_start
        if r.trace and r.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if r.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            r.prof = profile(activities=acts)
            r.prof.__enter__()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc) -> None:
        r = self.run
        r.sync()
        self.t1 = time.perf_counter()
        t1_ns = time.time_ns()
        r.window_s = self.t1 - self.t0
        if r.prof is not None:
            r.prof.__exit__(None, None, None)
            if exc[0] is None:
                r.trace_summary = summarize_trace(r.prof, self.t0_ns, t1_ns)
            r.prof = None


@dataclass
class Run:
    """One run of one cell: what the driver is given and what it reports."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    # "program", "control" (the cell's lower-precision stand-in) or the
    # name of a planted fault (see the drivers); the benchmark runs "program"
    variant: str = "program"
    e2e: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, List[float]] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    memory_peak_bytes: int = 0
    trace_summary: Optional[Trace] = None
    prof: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self) -> Window:
        return Window(self)

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value: float, limit: Optional[float] = None) -> None:
        """Record a compared number beside its limit (the cell's
        ``limits[name]`` unless given)."""
        if limit is None:
            limit = self.params.get("limits", {}).get(name, 0.0)
        self.checks[name] = [float(value), float(limit)]

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim for v, lim in self.checks.values()))


def per_layer_values(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.cell.per_layer:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run) -> dict:
    """The last line of a run's standard output."""
    import torch

    if run.trace:
        metrics = per_layer_values(run)
    else:
        metrics = {m["name"]: {"value": float(run.e2e["setup_s" if m["name"] == "setup_s"
                                                     else m["name"]]),
                               "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    cuda = run.device.type == "cuda"
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": run.cell.chips if cuda else 1,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        t = run.trace_summary
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.top_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def execute(run: Run) -> Run:
    """Drive the cell's traffic through the program and compare."""
    run.e2e.clear()
    driver(run.cell.kind).run(run)
    run.e2e["setup_s"] = run.setup_s
    return run
