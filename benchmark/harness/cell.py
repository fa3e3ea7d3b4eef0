"""A cell, resolved from BENCHMARK.json by name: its configuration file
(`configs/<config>.json`), its traffic file (`traffic/<traffic>.json`) and
that traffic's driver (`drivers/<driver>.py`), its configuration's domain
(`domains/<domain>.py`), and a reader for every metric it reports:
`metrics/<name>.py`, or for a name `<base>.<group>` with no file of its own
`metrics/<base>.py`; a group names the same quantity apart for cells whose
end-to-end bounds differ (`samples_per_s.scene`, `mfu.scene`).  Adding a
cell, a traffic mix or a metric adds files and entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run reports: end to end untraced, per layer traced."""
        return self.per_layer if trace else self.end_to_end

    def domain(self):
        return importlib.import_module(f"benchmark.domains.{self.config['domain']}")

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")


def reader_path(name: str, bench: Path = BENCH) -> Path:
    """metrics/<name>.py, or metrics/<base>.py for a name <base>.<group>."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = bench / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    return path


def reader(name: str, bench: Path = BENCH):
    """The module that reads metric `name` (reader_path)."""
    path = reader_path(name, bench)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = BENCH.parent) -> Cell:
    """The cell `workload` of root/BENCHMARK.json."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload) and m["moves"] in reported]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def readers(cell: Cell, trace: bool) -> Dict[str, object]:
    return {m["name"]: reader(m["name"]) for m in cell.metrics(trace)}
