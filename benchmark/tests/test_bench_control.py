"""The output check fails its control: the reference computed in fp8 (one
precision below the bf16 the configurations serve in), put in the program's
place.  On the card at each cell's own size on three seeds (marked `cuda`;
run there with `python -m pytest benchmark/tests -m cuda`), and on the CPU
at the small widths of tiny.py, where the program itself runs in float32."""

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell as cells
from benchmark.tests import tiny

CELLS = ("celebahq_256.sample.b32", "srn_cars.sample.b4")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's own size")
    from ddmi_tpu_torch.ops import build

    build.build_all(build.LIBRARIES)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    cell = cells.load(workload)
    limit = cell.config["check"]["limits"]["pixel_mae"]
    for seed in (3000000101, 3000000102, 3000000103):
        line = calibrate.reading(cell, seed, True, 1.0, "cuda")
        assert line["failed"] == 0 and line["requests"] > 0
        assert max(line["program"]) <= limit, line
        assert max(line["control"]) > limit, line


@pytest.mark.parametrize("which", ["image", "nerf"])
def test_control_fails_at_small_widths(which):
    torch.set_num_threads(2)
    name = "celebahq_256" if which == "image" else "srn_cars"
    limit = tiny._load(name)["check"]["limits"]["pixel_mae"]
    conf = tiny.image_conf(limit) if which == "image" else tiny.nerf_conf(limit)
    line = calibrate.reading(tiny.cell(conf), 5, True, 0.5, "cpu")
    assert max(line["program"]) <= limit
    assert max(line["control"]) > limit, line
