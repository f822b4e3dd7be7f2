"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in files of its
own under `h100_bench/`:

* `configs/<config>.json`: the configuration's sizes (the manifest's `file`);
* `models/<config>.py`: its adapter (builds the program, runs a request,
  and compares the timed path's outputs with the plain reference under
  `reference/`);
* `traffic/<traffic>.json`: the mix's parameters, read by `harness.traffic`;
* `metrics/<metric>.py`: one reader a per-layer metric.

Adding a cell, a configuration, a mix or a metric adds files; no file of
the harness names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")


class ManifestError(RuntimeError):
    """The manifest or a file it names is missing or malformed."""


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no {path}")
    return json.loads(path.read_text())


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise ManifestError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


def workload(manifest: dict, name: str) -> dict:
    return _one(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str) -> dict:
    return _one(manifest["configs"], name, "config")


def metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` prints: its end-to-end ones with
    tracing off, its per-layer ones with tracing on."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in names:
            out.append(m)
    return out


def read_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / "h100_bench" / kind / f"{name}.json"
    if not path.is_file():
        raise ManifestError(f"no {path}")
    return json.loads(path.read_text())


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """`h100_bench/<kind>/<name>.py`, loaded by path (names may hold dots
    and dashes)."""
    path = root / "h100_bench" / kind / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(manifest: dict) -> List[str]:
    """What in the manifest breaks the contract's naming and shape rules
    (empty when it is sound)."""
    out: List[str] = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(manifest) != keys:
        out.append(f"top-level keys {sorted(manifest)}")
    seen = set()

    def name_ok(name: str, what: str) -> None:
        if not isinstance(name, str) or not NAME.match(name):
            out.append(f"{what} name {name!r}")

    def unique(kind: str, entries: List[dict]) -> None:
        names = [e["name"] for e in entries]
        if len(set(names)) != len(names):
            out.append(f"duplicate {kind} names")

    for c in manifest["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')} keys {sorted(c)}")
        name_ok(c["name"], "config")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
        if not c["file"].startswith(tuple(p + "/" for p in manifest["paths"])):
            out.append(f"config file {c['file']} outside paths")
    unique("config", manifest["configs"])
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')} keys {sorted(w)}")
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        if w["config"] not in configs:
            out.append(f"workload {w['name']} config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
        if len(w["why"]) > 200 or "\n" in w["why"] or "\t" in w["why"]:
            out.append(f"workload {w['name']} why")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            out.append(f"pair {pair} twice")
        pairs.add(pair)
    unique("workload", manifest["workloads"])
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name_ok(m["name"], "metric")
        if m["name"] in seen:
            out.append(f"duplicate metric {m['name']}")
        seen.add(m["name"])
        if not UNIT.match(m["unit"]):
            out.append(f"metric {m['name']} unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']} better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']} source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m['name']} names cell {c}")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                      "source"}:
            out.append(f"metric {m['name']} keys {sorted(m)}")
        if m["source"] not in E2E_SOURCES:
            out.append(f"end-to-end metric {m['name']} source")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"metric {m['name']} bound {m['bound']}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in manifest["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                      "layer", "moves"}:
            out.append(f"metric {m['name']} keys {sorted(m)}")
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']} moves {m['moves']}")
    for w in manifest["workloads"]:
        names = [m["name"] for m in metrics(manifest, w["name"], False)]
        if "setup_s" not in names or len(names) < 2:
            out.append(f"cell {w['name']} end-to-end metrics {names}")
        per = metrics(manifest, w["name"], True)
        if not per:
            out.append(f"cell {w['name']} has no per-layer metric")
        for m in per:
            if m["moves"] not in names:
                out.append(f"cell {w['name']}: {m['name']} moves "
                           f"{m['moves']}, which the cell does not report")
    return out

