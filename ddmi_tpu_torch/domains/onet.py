"""Standalone ConvONet training (counterpart of
ddmi_tpu/domains/onet.py): the convocc subsystem's own trainer, apart from
the two-stage pipelines.  The binary cross-entropy of the query points'
occupancy logits, summed over the points and averaged over the batch;
Adam as optax's (core/optim.py); the IoU of the thresholded
probabilities; the encode-once closure the mesh extraction
(geometry/generation.py::MeshGenerator) evaluates.

`ENCODER_REGISTRY` maps the convocc `model.encoder` names to the port's
encoders.  PointNet++ is registered, as in JAX, and is selected by no
config: it gives per-point features, which LocalDecoder does not take.
One deliberate departure: an unknown encoder name raises ValueError, where
the JAX pipeline builds LocalPoolPointnet silently.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddmi_tpu_torch.core.convocc_config import (
    encoder_name,
    generation_kwargs,
    pointnet_kwargs,
    voxel_encoder_kwargs,
)
from ddmi_tpu_torch.core.device import resolve_device
from ddmi_tpu_torch.core.optim import AdamW
from ddmi_tpu_torch.nn.onet import ConvONet, LocalDecoder
from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet, LocalVoxelEncoder
from ddmi_tpu_torch.nn.pointnetpp import PointNetPlusPlus

ENCODER_REGISTRY = {
    "pointnet_local_pool": LocalPoolPointnet,
    "voxel_simple_local": LocalVoxelEncoder,
    "pointnet_plus_plus": PointNetPlusPlus,
}


@dataclasses.dataclass
class ONetState:
    """The update count and the optimizer (its moments and count)."""

    step: int
    opt: AdamW


class ONetPipeline(nn.Module):
    """`model`, a ConvONet of `encoder` (built from `encoder_kwargs`, c_dim
    filled in) and a LocalDecoder (`decoder_kwargs`), with parameters made
    on `device` (the card unless the caller asks for the CPU) from `seed`.
    A batch is a dict: `inputs` (b, n, 3) the surface cloud, or (b, r, r,
    r) the voxel grid; `points` (b, m, 3) the query points; `occ` (b, m)
    their occupancies."""

    def __init__(self, c_dim: int = 32, encoder: str = "pointnet_local_pool",
                 encoder_kwargs: Optional[Dict[str, Any]] = None,
                 decoder_kwargs: Optional[Dict[str, Any]] = None, lr: float = 1e-4,
                 threshold: float = 0.2, device="cuda", seed: int = 0):
        super().__init__()
        if encoder not in ENCODER_REGISTRY:
            raise ValueError(f"unknown encoder {encoder!r}; the registry holds "
                             f"{sorted(ENCODER_REGISTRY)}")
        self.lr, self.threshold = lr, threshold
        ek = dict(encoder_kwargs or {})
        ek.setdefault("c_dim", c_dim)
        dk = dict(decoder_kwargs or {})
        dk.setdefault("c_dim", c_dim)
        device = resolve_device(device)
        cuda = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            with device:
                self.model = ConvONet(ENCODER_REGISTRY[encoder](**ek), LocalDecoder(**dk))

    @classmethod
    def from_convocc(cls, conv_cfg: Dict[str, Any], device="cuda", seed: int = 0,
                     lr: float = 1e-4) -> "ONetPipeline":
        """The pipeline of a convocc YAML (core/convocc_config.py): its
        `model.encoder` with the encoder kwargs the JAX reader extracts,
        `model.decoder_kwargs`, `model.c_dim` and `test.threshold`."""
        name = encoder_name(conv_cfg)
        kw = voxel_encoder_kwargs(conv_cfg) if name == "voxel_simple_local" \
            else pointnet_kwargs(conv_cfg)
        model = conv_cfg.get("model") or {}
        return cls(c_dim=kw["c_dim"], encoder=name, encoder_kwargs=kw,
                   decoder_kwargs=model.get("decoder_kwargs") or {}, lr=lr,
                   threshold=generation_kwargs(conv_cfg)["threshold"], device=device, seed=seed)

    @property
    def device(self) -> torch.device:
        return self.model.decoder.fc_out.weight.device

    def init(self) -> ONetState:
        """A fresh optimizer over the model's parameters: Adam at `lr`, its
        moments fp32."""
        return ONetState(step=0, opt=AdamW(list(self.model.parameters()), self.lr,
                                           mu_dtype=torch.float32))

    def _on_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def loss(self, batch) -> torch.Tensor:
        """The BCE of the logits, summed over the points, mean over the batch."""
        b = self._on_device(batch)
        logits = self.model(b["points"].float(), b["inputs"])
        bce = F.binary_cross_entropy_with_logits(logits, b["occ"].float(), reduction="none")
        return bce.sum(-1).mean()

    def train_step(self, state: ONetState, batch):
        """One Adam step on the batch's loss -> (state, {"loss": float})."""
        params = list(self.model.parameters())
        loss = self.loss(batch)
        grads = torch.autograd.grad(loss, params)
        state.opt.update(params, list(grads))
        state.step += 1
        return state, {"loss": float(loss.detach())}

    @torch.no_grad()
    def eval_iou(self, batch) -> float:
        """The batch's mean IoU of logits above the threshold's logit against
        occupancies above 0.5, each union at least 1."""
        b = self._on_device(batch)
        logits = self.model(b["points"].float(), b["inputs"]).cpu().numpy()
        thr = float(np.log(self.threshold) - np.log(1 - self.threshold))
        pred = logits > thr
        occ = np.asarray(torch.as_tensor(batch["occ"]).cpu()) > 0.5
        inter = np.logical_and(pred, occ).sum(-1)
        union = np.logical_or(pred, occ).sum(-1).clip(1)
        return float((inter / union).mean())

    def mesh_eval_fn(self, inputs):
        """Encodes `inputs` (1, ...) once -> points (1, n, 3) -> logits (1, n)
        on those features, for MeshGenerator."""
        with torch.no_grad():
            planes = self.model.encode_inputs(torch.as_tensor(inputs).to(self.device))

        def eval_points(points):
            return self.model.decode(points, planes)

        return eval_points
