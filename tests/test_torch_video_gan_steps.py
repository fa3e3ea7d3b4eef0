"""Two accumulation windows of the ported adversarial video train step (the
2D + 3D PatchGAN pair, configs like skytimelapse_gan.yaml) against the JAX
package's, on the CPU; tests/test_torch_video_steps.py holds the
procedure and states its tolerances.
"""

import torch

from test_torch_video_steps import run_stage1_windows

torch.set_num_threads(1)


def test_adversarial_stage1_train_steps_match_jax():
    run_stage1_windows(adversarial=True)
