"""``BENCHMARK.json`` and the files a cell names."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file, as read
    traffic: dict         # the traffic file, as read
    chips: int
    end_to_end: list      # metric entries this cell reports with --trace 0
    per_layer: list       # metric entries this cell reports with --trace 1


def load(root) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def traffic_path(root, name: str) -> Path:
    return Path(root) / "benchmark" / "traffic" / f"{name}.json"


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def resolve(root, cell_name: str) -> Cell:
    bench = load(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads(traffic_path(root, w["traffic"]).read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, cell_name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, cell_name, names)]
    return Cell(cell_name, config, traffic, int(w["chips"]), e2e, per_layer)
