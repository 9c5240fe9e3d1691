"""What a run is handed, what a driver gives back, and how the result
line is made.

``BENCHMARK.json`` names a cell; the cell names a configuration and a
traffic mix.  The configuration is ``portbench/configs/<name>.json``
(the program's configuration keys, plus a ``meta`` block that the run
drops), the traffic ``portbench/traffic/<name>.json`` (it names its
driver, ``portbench/drivers/<driver>.py``, and that driver's
parameters), the comparison's limits ``portbench/limits/<cell>.json``,
and each per-layer metric ``portbench/metrics/<metric>.py`` (its
``read(ctx)``).  Nothing here knows a cell, a mix or a metric by name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mca_tpu")


@dataclass
class Run:
    """One run of one cell, as a driver receives it."""

    cell: dict
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    rank: int = 0
    world: int = 1


@dataclass
class Outcome:
    """What a driver gives back.  ``e2e`` holds the end-to-end numbers
    it measured (``setup_s`` is the harness's); ``ctx`` what the
    per-layer readers read; ``checks`` each compared number as ``(name,
    value, limit)``."""

    attempted: int
    failed: int
    window_start: float
    e2e: Dict[str, float]
    ctx: Dict[str, Any]
    checks: List[Tuple[str, float, Optional[float]]]
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in the benchmark")


def config_of(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = load_json(root / c["file"])
            cfg.pop("meta", None)
            return cfg
    raise SystemExit(f"no configuration {name!r} in the benchmark")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(name: str):
    """The ``read`` of ``portbench/metrics/<name>.py`` (names may hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of_cell(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The cell's end-to-end and per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quartile_spread(values: List[float]) -> float:
    """Interquartile distance as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def check_verdict(checks: List[Tuple[str, float, Optional[float]]]) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return bool(checks) and all(
        lim is not None and math.isfinite(v) and v <= lim for _, v, lim in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Tuple[float, str]],
                device: Dict[str, Any], checks, breakdown=None) -> str:
    out: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)
