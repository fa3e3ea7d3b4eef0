"""The harness is data: a cell, a traffic mix and a per-layer metric are
added by new files and new BENCHMARK.json entries alone; and BENCHMARK.json
keeps to the benchmark's rules of names, units and metrics."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_traffic_and_metric_are_files_and_entries(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")

    conf = json.loads((BENCH / "configs" / "celebahq_256.json").read_text())
    conf["serve"]["resolution"] = 1024
    (tmp_path / "benchmark/configs/celebahq_r1024.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark/traffic/sample.b8.json").write_text(json.dumps(
        {"driver": "closed_loop_service", "service_batch": 8, "clients": 16, "n": 1,
         "linger_ms": 20.0, "timeout_s": 300, "trace_batches": 2}))
    (tmp_path / "benchmark/metrics/batches_traced.sample.py").write_text(
        "def read(run):\n    return run.trace.batches if run.trace is not None else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "celebahq_r1024", "source": spec["configs"][0]["source"],
                            "file": "benchmark/configs/celebahq_r1024.json", "reduced": [],
                            "why": "a larger render"})
    spec["workloads"].append({"name": "celebahq_r1024.sample.b8", "config": "celebahq_r1024",
                              "traffic": "sample.b8", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("celebahq_r1024.sample.b8")
    spec["per_layer"].append({"name": "batches_traced.sample", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "service", "moves": "samples_per_s",
                              "workloads": ["celebahq_r1024.sample.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        "import sys, json; from pathlib import Path; sys.path.insert(0, %r)\n"
        "from benchmark.harness import cell\n"
        "c = cell.load('celebahq_r1024.sample.b8', Path(%r))\n"
        "r = cell.readers(c, True)\n"
        "class T: batches = 3\n"
        "class R: trace = T()\n"
        "print(json.dumps({'file': cell.__file__, 'traffic': c.traffic['service_batch'],"
        " 'res': c.config['serve']['resolution'], 'e2e': [m['name'] for m in c.end_to_end],"
        " 'layer': sorted(r), 'read': r['batches_traced.sample'].read(R()),"
        " 'driver': c.driver().__name__, 'domain': c.domain().__name__}))\n"
    ) % (str(tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["traffic"] == 8 and got["res"] == 1024
    assert got["e2e"] == ["samples_per_s", "setup_s"]
    assert "batches_traced.sample" in got["layer"] and "mfu.sample" in got["layer"]
    assert got["read"] == 3
    assert got["driver"].endswith("closed_loop_service") and got["domain"].endswith("image")
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_to_its_rules():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in spec["workloads"]] + [
        c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e, m["name"]
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert cell.reader_path(m["name"], BENCH).is_file()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in spec["workloads"]}
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
        # every cell reports setup_s, another end-to-end metric and a per-layer one
        e = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) and m["moves"] in
                   {x["name"] for x in e} for m in spec["per_layer"])
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
