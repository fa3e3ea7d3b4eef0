"""Two accumulation windows of the ported adversarial stage-1 train step
(the PatchGAN with every DiffAugment policy) against the JAX package's, on
the CPU; tests/test_torch_stage1_steps.py holds the procedure
(`run_stage1_steps`) and states its tolerances.
"""

import pytest
import torch

from test_torch_stage1_steps import run_stage1_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("adversarial", [True])
def test_stage1_train_steps_match_jax(adversarial):
    run_stage1_steps(adversarial)
