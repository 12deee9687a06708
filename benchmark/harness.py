"""What every cell shares: BENCHMARK.json and the files it names, the
cache directories, the process's start, the look for modules that must not
load, and the assembly of the result's line.

A cell names a configuration (benchmark/configs/<name>.json, whose
"codec" names benchmark/codecs/<codec>.py) and a traffic mix
(benchmark/traffic/<name>.json, whose "kind" names the loop in
benchmark/loops/<kind>.py). A per-layer metric <name> is read by
benchmark/metrics/<name>.py. So a new configuration, mix or metric is new
files and entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no process of the benchmark may load: the
# reference package (JAX) and JAX itself
BANNED = ("jax", "jaxlib", "flax", "ceracoder_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    banned, compared whole: ceracoder_tpu_torch is not ceracoder_tpu."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def by_name(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded by its path (names may hold
    dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found for {kind} {name!r}")
    mod_name = f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    program builds its nvcc and g++ libraries into <checkout>/build
    itself; these cover PyTorch's extension and Triton caches."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def process_start_s() -> float:
    """This process's start on the wall clock (seconds since the epoch),
    from /proc (in clock ticks since boot); the import time of this
    module where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


@dataclass
class Cell:
    """One cell as BENCHMARK.json and its files define it."""
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, name: str, spec: dict | None = None) -> "Cell":
        spec = spec or benchmark_spec()
        wl = by_name(spec["workloads"], name, "workload")
        cfg_entry = by_name(spec["configs"], wl["config"], "config")
        config = load_json(ROOT / cfg_entry["file"])
        traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
        e2e = [m for m in spec["end_to_end"]
               if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in e2e_names)]
        return cls(wl, config, traffic, e2e, per_layer)


@dataclass
class Run:
    """What a loop gives back: end-to-end values by name, the frames
    attempted and failed, the device's peak, the trace (or None) and the
    checks of `correct` as (name, value, limit, passed)."""
    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    checks: list = field(default_factory=list)


def result_line(cell: Cell, run: Run, device: dict, trace_on: bool) -> dict:
    """The result's JSON object, `checks` last."""
    metrics = {}
    breakdown = None
    if not trace_on:
        for m in cell.end_to_end:
            if m["name"] in run.end_to_end:
                metrics[m["name"]] = {"value": run.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(run.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None:
            device = dict(device, busy_s=run.trace.busy_s(),
                          window_s=run.trace.window_s)
            breakdown = run.trace.breakdown()
    correct = bool(run.checks) and all(c[3] for c in run.checks)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c[0]: {"value": c[1], "limit": c[2]}
                     for c in run.checks}
    return out


def check_lines(run: Run) -> list[str]:
    return [f"check {name} {value} limit {limit} "
            f"{'ok' if passed else 'FAILED'}"
            for name, value, limit, passed in run.checks]
