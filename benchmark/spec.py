"""Find a cell's parts by name: its entry in BENCHMARK.json, its
configuration (`configs/<config>.json`), its traffic (`traffic/<traffic>.json`,
whose `kind` names the runner `runners/<kind>.py`), the limits of its
correctness check (`limits/<cell>.json`), and the metrics it reports, each
per-layer one read by `metrics/<name>.py`.  A cell, a configuration, a
traffic mix or a metric is added as files and entries; nothing here names
one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict = None) -> SimpleNamespace:
    """Everything a run of the cell `name` needs, found by name."""
    bench = bench or benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entry[0]
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{name}.json"
    return SimpleNamespace(
        name=name, entry=entry, chips=entry["chips"],
        config=load_json(ROOT / conf["file"]), traffic=traffic,
        limits=load_json(limits_path) if limits_path.exists() else None,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def runner(kind: str) -> ModuleType:
    return importlib.import_module(f"benchmark.runners.{kind}")


def reader(metric: str) -> ModuleType:
    """The module of `metrics/<metric>.py` (a name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(device_name: str, dtype: str) -> Dict[str, float]:
    """{'part', 'flops', 'bytes_per_s'} of the card whose name matches."""
    for card in load_json(HERE / "peaks.json")["cards"]:
        if any(m in device_name for m in card["match"]):
            return {"part": card["part"], "flops": card["flops"][dtype],
                    "bytes_per_s": card["bytes_per_s"]}
    raise SystemExit(f"no published peak for {device_name!r} in "
                     f"benchmark/peaks.json")
