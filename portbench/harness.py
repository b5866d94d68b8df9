"""Loads a cell and runs it once.

Everything that belongs to one configuration, mix, cell or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration (widths, weights, precision,
  resolution, decode and refiner options, camera) and the program module
  that knows its model family (``programs/<program>.py``);
- ``mixes/<traffic>.json``: the traffic mix, the driver that generates it
  (``drivers/<driver>.py``) and its parameters;
- ``workloads/<cell>.json``: the cell's own parameters over the mix's, the
  limits of the readings that decide ``correct`` and the faults that must
  fail it;
- ``metrics/<metric>.py``: a per-layer reader, ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepcharuco_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell ``name`` as one dict: its ``BENCHMARK.json`` entry, its
    configuration and program module, its mix's driver, the merged
    parameters, its limits and faults, and the metrics it reports."""
    spec = spec or benchmark()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    mix = load_json(BENCH / "mixes" / f"{entry['traffic']}.json")
    own = load_json(BENCH / "workloads" / f"{name}.json")
    params = {**mix["params"], **own.get("params", {})}
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    config = load_json(ROOT / conf["file"])
    return {"name": name, "entry": entry, "config": config,
            "program": importlib.import_module(f"portbench.programs.{config['program']}"),
            "driver": mix["driver"], "params": params, "limits": own["limits"],
            "faults": own.get("faults", []), "end_to_end": e2e, "per_layer": layer}


def driver(c: dict):
    """The module of cell ``c``'s driver (``drivers/<driver>.py``)."""
    return importlib.import_module(f"portbench.drivers.{c['driver']}")


class Clock:
    """Seconds since the process started (``/proc`` where it exists, else
    since this module was imported)."""

    def __init__(self):
        self.t_import = time.perf_counter()
        self.before = 0.0
        try:
            with open("/proc/self/stat") as f:
                start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
            with open("/proc/uptime") as f:
                uptime = float(f.read().split()[0])
            self.before = max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
        except (OSError, ValueError, IndexError):
            pass

    def since_start(self) -> float:
        return self.before + time.perf_counter() - self.t_import


CLOCK = Clock()


def cache_dirs() -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    port builds its CUDA kernels into ``build/kernels`` by itself)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             fault: Optional[str] = None, overrides: Optional[dict] = None,
             spec: Optional[dict] = None) -> dict:
    """One run of cell ``name``: set-up, the window, the comparison. Returns
    the result line's object. ``device`` None is the card; ``fault`` plants
    one of the program module's ``FAULTS`` in the timed path; ``overrides``
    replace mix parameters (the tests' small sizes)."""
    return run_once(name, seed, seconds, trace, device, fault, overrides, spec)[0]


def run_once(name, seed, seconds, trace, device=None, fault=None, overrides=None, spec=None):
    """:func:`run_cell`'s result, the run, and every reading the
    comparison took (the result's ``checks`` hold those with a limit)."""
    import torch

    c = cell(name, spec)
    c["params"].update(overrides or {})
    if device is None:
        device = torch.device("cuda", 0)
    run = driver(c).Run(c, seed, seconds, trace, device, fault)
    run.setup()
    if run.stretch is not None:
        run.stretch.warm()
    run.setup_s = CLOCK.since_start()
    run.window()
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed}
    dev = device_info(device)
    if trace:
        busy = run.stretch.busy()
        if busy is not None:
            dev["busy_s"], dev["window_s"] = busy
        metrics = {}
        for m in c["per_layer"]:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**run.e2e, "setup_s": run.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    run.release()
    readings = run.judge()
    checks = {k: {"value": readings[k], "limit": v} for k, v in c["limits"].items()}
    result["correct"] = run.failed == 0 and all(v["value"] <= v["limit"]
                                                for v in checks.values())
    result.update(metrics=metrics, device=dev)
    if trace and run.stretch.ops:
        result["breakdown"] = run.stretch.breakdown()
    result["checks"] = checks
    return result, run, readings
