"""The benchmark's machinery, driven by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's file (``configs`` entry) names its model family,
``perfbench/families/<family>.py``; the traffic mix is
``perfbench/traffic/<traffic>.json`` and names its task,
``perfbench/tasks/<task>.py``, the loop that drives the port.  Each metric
has a reader, ``perfbench/metrics/<name>.py`` or, for ``name.suffix``,
``perfbench/metrics/<name>.py`` of the part before the first dot, whose
``read(run)`` returns the number or None where it finds nothing to read.
So a configuration, a traffic mix or a metric is added with files and
entries alone.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "lsdm_tpu")
UNIT, ENCODE, DRAIN = "perfbench.unit", "perfbench.encode", "perfbench.drain"


def prepare_environment(root: Path = ROOT) -> None:
    """Keep every build and kernel cache at a fixed path inside the
    checkout, and clear the work directories of a port build that was cut
    (``build/lsdm_tpu_torch/*.<pid>.tmp`` of a process that is gone)."""
    cache = root / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for work in (root / "build" / "lsdm_tpu_torch").glob("*.tmp"):
        try:
            pid = int(work.name.split(".")[-2])
        except (IndexError, ValueError):
            continue
        if not Path(f"/proc/{pid}").exists():
            shutil.rmtree(work, ignore_errors=True)


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


class Spec:
    """``BENCHMARK.json`` and what its names point to."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.data = json.loads((root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key} has no entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "perfbench" / "traffic" / f"{name}.json").read_text())

    def metrics_for(self, workload: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list it under ``workloads``, and a metric without
        that key in every cell (a per-layer one in every cell that reports
        the end-to-end metric it moves)."""
        if not trace:
            return [m for m in self.data["end_to_end"]
                    if workload in m.get("workloads", [workload])]
        moved = {m["name"] for m in self.metrics_for(workload, False)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]


def reader(name: str, metrics_dir: Path = PKG / "metrics"):
    """The ``read`` function of metric ``name``."""
    base = name if (metrics_dir / f"{name}.py").exists() else name.split(".")[0]
    return importlib.import_module(f"perfbench.metrics.{base}").read


def unit_range(active: bool):
    """A profiler range around one request or step, where the run traces."""
    if not active:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(UNIT)


class Cell:
    """One cell as a run sees it: its configuration, traffic, family and
    task, and the trace of the ``--trace 1`` run."""

    def __init__(self, spec: Spec, workload: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float):
        wl = spec.workload(workload)
        self.name = workload
        self.cfg = spec.config(wl["config"])
        self.traffic = spec.traffic(wl["traffic"])
        self.family = importlib.import_module(f"perfbench.families.{self.cfg['family']}")
        self.task = importlib.import_module(f"perfbench.tasks.{self.traffic['task']}")
        self.seed, self.seconds, self.device = seed, seconds, device
        self.t_start = t_start
        self.tracing = bool(trace)
        self.encode_hook = self._encode if trace else None
        self.prof = None
        self.trace_stop: Optional[Tuple[float, int]] = None  # (time, units before it)
        self.phases: List[Tuple[str, float]] = [("imports", time.perf_counter())]

    def mark(self, phase: str) -> None:
        """End a phase of set-up (printed on standard error)."""
        self.phases.append((phase, time.perf_counter()))

    @staticmethod
    def _encode(fn, *args, **kwargs):
        import torch

        with torch.profiler.record_function(ENCODE):
            return fn(*args, **kwargs)

    def trace_step(self, units: int, last: bool = False) -> None:
        """Called before each unit of the window (with the count so far) and
        once after it (``last``): the ``--trace 1`` run traces the first
        ``trace_units`` units, then drains the device and stops."""
        if not self.tracing or self.trace_stop is not None:
            return
        import torch

        if self.prof is None and not last:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        elif self.prof is not None and (last or units >= self.traffic["trace_units"]):
            with torch.profiler.record_function(DRAIN):
                self.sync()
            self.prof.__exit__(None, None, None)
            self.trace_stop = (time.perf_counter(), units)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Run:
    """What a task hands the metric readers."""

    def __init__(self, cell: Cell, setup_s: float):
        self.cell = cell
        self.setup_s = setup_s
        self.units: List[Tuple[float, float, int]] = []  # (start, end, scenes)
        self.window: Optional[Tuple[float, float]] = None
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.failed = 0
        self.memory_peak = 0
        self.modules: List[str] = []
        self.trace = None  # trace.Summary of the --trace 1 run
        self.control = None  # the control's readings, on demand
        self.flops_per_scene = 0.0

    def close_window(self, end: Optional[float] = None) -> None:
        """End the window (at the last unit's end unless given), read the
        memory peak and the modules loaded."""
        import torch

        self.window = (self.units[0][0], end if end is not None
                       else max(e for _, e, _ in self.units))
        if self.cell.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.cell.device)
        self.modules = banned_modules()

    def check(self, readings: Dict[str, float]) -> None:
        limits = self.cell.cfg["limits"][self.cell.traffic["task"]]
        self.checks = {k: (float(v), float(limits[k])) for k, v in readings.items()}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())

    @property
    def scenes(self) -> int:
        return sum(n for _, _, n in self.units)

    def untraced(self) -> Optional[Tuple[int, float]]:
        """(scenes, seconds) of the window after the trace stopped (all of
        it in an untraced run); None where nothing is left."""
        if self.cell.trace_stop is None:
            return self.scenes, self.window[1] - self.window[0]
        t_stop, k = self.cell.trace_stop
        rest = self.units[k:]
        if not rest or self.window[1] <= t_stop:
            return None
        return sum(n for _, _, n in rest), self.window[1] - t_stop


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> Tuple[Optional[dict], Run]:
    """Run one cell once: (the result line, or None where the run loaded a
    module it may not; the run)."""
    cell = Cell(spec, workload, seed, seconds, trace, device, t_start)
    run = cell.task.run(cell)
    run.modules = sorted(set(run.modules) | set(banned_modules()))
    times = [t_start] + [t for _, t in cell.phases]
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (name, _), a, b
                                 in zip(cell.phases, times, times[1:])), file=sys.stderr)
    if run.modules:
        print(f"perfbench: modules that may not be loaded: {run.modules}", file=sys.stderr)
        return None, run
    if cell.prof is not None:
        from perfbench.trace import summarize

        run.trace = summarize(cell.prof)
        cell.prof = None
        print(f"trace: {run.trace.units} units, {run.trace.unattributed} device "
              "operations without a launch event", file=sys.stderr)
    metrics = {}
    for m in spec.metrics_for(workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    import torch

    on_gpu = device.type == "cuda"
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": run.correct, "attempted": len(run.units), "failed": run.failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result, run


def print_result(result: dict) -> None:
    """The result as the last line of standard output, and each number
    compared beside its limit as the last lines of standard error."""
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
