"""A run with the timed path broken underneath comes out not correct.

The run's look for a chip is skipped (the service runs on the CPU, in
float32, at the small widths of tiny.py) and the rest of the run is as on
the card, with each cell's own limit.  The faults a sampling cell can have:
a DDIM step that returns its state unchanged, half of a service batch left
out (its samples copied from the other half), and every answer altered
where it is produced (the render's pixels moved by 4 levels of 255).  A
cell on one chip has no exchange between chips to leave out."""

import json

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.tests import tiny

torch.set_num_threads(2)


def _limit(name):
    return tiny._load(name)["check"]["limits"]["pixel_mae"]


CASES = {"image": (lambda: tiny.image_conf(_limit("celebahq_256")), "decode_latents"),
         "nerf": (lambda: tiny.nerf_conf(_limit("srn_cars")), "render_nerfs")}


def _run(monkeypatch, capsys, which, seed):
    import benchmark.run as run

    c = tiny.cell(CASES[which][0]())
    monkeypatch.setattr(cells, "load", lambda name, root=None: c)
    rc = run.main(["--workload", "tiny", "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                  device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("which", ["image", "nerf"])
def test_sound_run_is_correct(monkeypatch, capsys, which):
    out = _run(monkeypatch, capsys, which, 3000000019)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


def _unchanged_step(monkeypatch, which):
    from ddmi_tpu_torch.diffusion import process

    monkeypatch.setattr(process, "_ddim_update", lambda sched, eta, img, *a, **k: img)


def _half_batch(monkeypatch, which):
    from ddmi_tpu_torch.serve.server import SamplerService

    orig = SamplerService._sample

    def half(self, noise, seed):
        h = noise.shape[0] // 2
        return orig(self, torch.cat([noise[:h], noise[:h]] + [noise[2 * h :]]), seed)

    monkeypatch.setattr(SamplerService, "_sample", half)


def _altered(monkeypatch, which):
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    cls = ImagePipeline if which == "image" else NeRFPipeline
    name = CASES[which][1]
    orig = getattr(cls, name)
    monkeypatch.setattr(cls, name, lambda self, *a, **k: orig(self, *a, **k) + 4.0 / 255.0)


@pytest.mark.parametrize("which", ["image", "nerf"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _altered])
def test_fault_is_not_correct(monkeypatch, capsys, which, fault):
    fault(monkeypatch, which)
    out = _run(monkeypatch, capsys, which, 3000000019)
    assert not out["correct"], out["check"]
    assert out["check"]["pixel_mae"]["value"] > out["check"]["pixel_mae"]["limit"]


@pytest.mark.parametrize("batch,k", [(4, 3), (32, 8)])
def test_the_check_reaches_the_second_half_of_a_batch(batch, k):
    """On every seed the check's sample holds a request from the second
    half of a batch, so a fault there is always seen."""
    from types import SimpleNamespace

    from benchmark.harness import check

    done = [SimpleNamespace(seed=100 + i) for i in range(6 * batch)]
    placed = {r.seed: (100 + (r.seed - 100) // batch * batch, (r.seed - 100) % batch)
              for r in done}
    for seed in range(3000000000, 3000000200):
        chosen = check.choose(done, k, seed, placed)
        assert len({r.seed for r in chosen}) == k
        assert any(placed[r.seed][1] >= batch // 2 for r in chosen)
