"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
lists the metrics. Each part is a file of its own under the benchmark's
folder, found by its name alone:

- a configuration: the ``file`` its entry in ``BENCHMARK.json`` gives
  (``configs/<config>.json``);
- a traffic mix: ``traffic/<mix>.json``, parameters that the
  general generator (:mod:`.traffic`) and the drivers (:mod:`.cells`) read;
- a metric: ``metrics/<metric>.py``, a reader with ``read(run)`` that
  returns the number or None (nothing to read: the metric is left out).

So a later change adds a configuration, a mix or a metric by adding files
and entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of the config entry ``name``."""
    entry = _entry(bench["configs"], name, "config")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The parameters of the traffic mix ``name``."""
    path = Path(bench_dir) / "traffic" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path}")
    return json.loads(path.read_text())


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of the metric ``name``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell_name: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones, or with ``trace`` the per-layer ones. An entry with
    ``workloads`` applies to the cells it lists; an end-to-end entry
    without it to every cell, a per-layer one to every cell that reports
    the end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, set())]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if _applies(m, cell_name, names)]
