"""No module the benchmark runs imports JAX, its libraries or the JAX
package (top-level names compared whole, so `ddmi_tpu_torch` passes), and
the plain reference imports nothing of the package under test."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import guard

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _run_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["ddmi_tpu_torch", "ddmi_tpu_torch.ops", "numpy"]) == []
    assert guard.forbidden_loaded(["ddmi_tpu.ops", "jax._src.core", "jaxlib", "flax.linen",
                                   "optax"]) == ["ddmi_tpu", "flax", "jax", "jaxlib", "optax"]
    assert guard.forbidden_loaded(["jaxtyping", "flaxen"]) == []


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    bad = [(p.name, m) for p in _run_files() for m in _imports(p)
           if m.split(".")[0] in guard.FORBIDDEN]
    assert bad == []


def test_the_reference_imports_nothing_of_the_port():
    bad = [(p.name, m) for p in (BENCH / "reference").glob("*.py") for m in _imports(p)
           if m.split(".")[0].startswith("ddmi_tpu")]
    assert bad == []


def test_a_run_loads_no_forbidden_module():
    """Everything the run imports, in a fresh interpreter: the harness, the
    domains, every metric reader and the served path of the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.harness import cell, check, session, trace, guard\n"
        "from benchmark.domains import image, nerf\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "for m in spec['end_to_end'] + spec['per_layer']: cell.reader(m['name'])\n"
        "from ddmi_tpu_torch.serve.server import SamplerService\n"
        "from ddmi_tpu_torch.ops import build\n"
        "print(guard.forbidden_loaded())\n"
        "import benchmark.reference.adm_unet, benchmark.reference.nerf\n"
    ) % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_without_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.adm_unet, benchmark.reference.ldm_decoder\n"
            "import benchmark.reference.inr_image, benchmark.reference.nerf\n"
            "import benchmark.reference.ddim, benchmark.reference.philox\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('ddmi_tpu')))\n"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
