"""A cell of ``BENCHMARK.json``, found by name, with the files that belong
to it, each found by the name the manifest gives it:

- the configuration: the file named in ``configs`` (sizes as the model's
  published ``config.json`` names them, and what the benchmark fixed);
- the traffic mix: ``benchmark/traffic/<traffic>.json``, parameters that
  the generator of its ``kind`` reads: ``benchmark/kinds/<kind>.py``;
- the per-layer metrics: ``benchmark/metrics/<metric>.py``, each a
  ``read(run)`` that returns a number or None;
- the limits of the output check: ``benchmark/limits/<cell>.json``;
- the controls of the output check, found by the name a run is given:
  ``benchmark/controls/<control>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List


def load_manifest(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(root: Path, workload: str) -> Dict:
    bench = load_manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"options: {sorted(cells)}")
    cell = dict(cells[workload])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["config_entry"] = conf
    cell["config"] = json.loads((root / conf["file"]).read_text())
    cell["mix"] = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    reported = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if m["name"] in reported]
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [])
                         or ("workloads" not in m and m["moves"] in reported)]
    return cell


def _module(root: Path, folder: str, name: str):
    path = root / "benchmark" / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    return _module(root, "metrics", name).read


def kind(root: Path, name: str):
    """The generator of a mix kind: ``inputs(mix, seed, seconds)`` and
    ``window(ctx)`` (``harness.loop``)."""
    return _module(root, "kinds", name)


def control(root: Path, name: str):
    """A control of the output check (``harness.check``)."""
    return _module(root, "controls", name)


def metric_names(cell: Dict, trace: bool) -> List[str]:
    return [m["name"] for m in (cell["per_layer"] if trace
                                else cell["end_to_end"])]
