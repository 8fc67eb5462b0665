"""Finds a cell's files by name, reduces traces, and prints the result line.

Everything a cell needs is found from the names in ``BENCHMARK.json``:

- the cell's ``config`` -> ``configs/<config>.json`` (sizes and the recipe);
- its ``traffic`` -> ``traffic/<traffic>.json``, whose ``loop`` names
  ``loops/<loop>.py`` (the generator that reads the traffic's parameters);
- its limits of correctness -> ``limits/<cell>.json``;
- each ``per_layer`` metric that lists the cell -> ``metrics/<metric>.py``, a
  reader ``read(run) -> float | None`` (None: nothing to read, left out).

So a later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import math
import sys
import tempfile
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell: str, benchmark: Optional[dict] = None, bench_dir: Path = BENCH_DIR):
    """Everything one cell needs, found by name: raises ``KeyError`` for a
    cell ``BENCHMARK.json`` does not name and ``FileNotFoundError`` for a
    missing file."""
    if benchmark is None:
        benchmark = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if cell not in cells:
        raise KeyError(f"workload {cell!r} is not in BENCHMARK.json: {sorted(cells)}")
    entry = cells[cell]
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    per_layer = [m for m in benchmark["per_layer"] if _applies(m, cell)]
    return SimpleNamespace(
        name=cell, entry=entry,
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=traffic,
        loop=load_module(bench_dir / "loops" / f"{traffic['loop']}.py",
                         f"bench_loop_{traffic['loop']}"),
        limits=load_json(bench_dir / "limits" / f"{cell}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if _applies(m, cell)],
        per_layer=per_layer,
        readers={m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                        f"bench_metric_{m['name']}")
                 for m in per_layer},
    )


# -- the program -----------------------------------------------------------------
def load_params(model, params0: dict) -> None:
    """Set every parameter of the program's model to the benchmark's draw;
    the names and shapes must match the reference's exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(params0):
        raise RuntimeError(f"parameters differ from the reference's: only in the program "
                           f"{sorted(set(params) - set(params0))[:5]}, only in the "
                           f"reference {sorted(set(params0) - set(params))[:5]}")
    for name, p in params.items():
        if p.shape != params0[name].shape:
            raise RuntimeError(f"{name}: program {tuple(p.shape)}, reference "
                               f"{tuple(params0[name].shape)}")
        with torch.no_grad():
            p.copy_(params0[name])


# -- traces -------------------------------------------------------------------
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def _events(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def _busy(events: List[dict]) -> List[tuple]:
    return _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATS])


def _top(d: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def summarize_trace(trace: dict, window_s: float, steps: int) -> dict:
    """Reduce a ``torch.profiler`` chrome trace of ``steps`` steps (or rounds)
    over ``window_s`` seconds of host time: ``kernels``, (name, start us,
    duration us) of each device kernel; ``busy_s``, the union of every device
    operation's interval (kernels, copies, sets); ``device_ops``, the ten
    kernel names with the most device time."""
    events = _events(trace)
    kernels = [(e["name"], float(e["ts"]), float(e["dur"]))
               for e in events if e.get("cat") == "kernel"]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, _, dur in kernels:
        by_name[name] += dur * 1e-6
    return {"kernels": kernels, "busy_s": sum(b - a for a, b in _busy(events)) * 1e-6,
            "window_s": window_s, "steps": steps, "device_ops": _top(by_name)}


def idle_gaps(trace: dict) -> List[list]:
    """The device's idle time between its first and last operation in a trace
    that holds host events too, each gap charged to the innermost host op or
    annotation running at its middle: the ten largest totals (name, s)."""
    events = _events(trace)
    busy = _busy(events)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    idle: Dict[str, float] = collections.defaultdict(float)
    # one sweep: the gaps come in time order; the stack holds the host ops
    # begun before the gap's middle, the latest begun on top, and an op that
    # ended before one middle has ended before every later one
    stack: List[tuple] = []
    i = 0
    for start, end in gaps:
        mid = 0.5 * (start + end)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else "no host op"] += (end - start) * 1e-6
    return _top(idle)


def kernel_seconds(trace: dict, *fragments: str) -> float:
    """Device seconds of the kernels whose names hold any of ``fragments``."""
    return sum(d for n, _, d in trace["kernels"] if any(f in n for f in fragments)) * 1e-6


def profiler(cuda: bool, host: bool):
    """``torch.profiler`` over the card's activity, and the host's with ``host``
    (or on a machine without a card)."""
    activities = []
    if host or not cuda:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def warm_profiler(device) -> None:
    """Start and stop the profiler once, in set-up: its first start in a
    process sets up the card's tracing, which takes seconds."""
    with profiler(device.type == "cuda", host=True):
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize()


def chrome_trace(prof) -> dict:
    """The profile as a chrome trace; read it before the next profile starts,
    which clears the tracer's buffers."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return load_json(path)


# -- the result line -----------------------------------------------------------
def emit(cell, outcome: dict, trace: bool, device: dict) -> bool:
    """Print the cell's result as the last line of standard output and the
    compared numbers as the last lines of standard error; returns ``correct``."""
    checks = outcome["checks"]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and outcome["failed"] == 0
    metrics = {}
    if trace:
        run = SimpleNamespace(cell=cell, **outcome)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        summary = outcome["trace"]
        device = dict(device, busy_s=summary["busy_s"], window_s=summary["window_s"])
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome["end_to_end"][m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": outcome["trace"]["device_ops"],
                               "idle_gaps": outcome["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else None,
                            "limit": c["limit"]} for k, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return correct
