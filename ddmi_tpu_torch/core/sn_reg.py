"""The spectral-norm regulariser of stage-1 training (counterpart of
ddmi_tpu/core/sn_reg.py; reference utils/sr_utils.py).

Every kernel that is a 4-D convolution in the JAX package (1x1 attention,
quant and HDBF convs included; the video VAE's Dense layers, whose kernels
are 2-D there, are not) is flattened to an (out, kh * kw * in) matrix with
its columns in the JAX package's (kh, kw, in) order, and the matrices are
grouped by shape under the key f"{out}x{kh * kw * in}".  Within a group
they are stacked in the order of their JAX parameter paths (the VAE's
`jax_layout()`: nn/vae.py for the image VAE, nn/video_vae.py for the
video one) sorted as strings, so "Conv_10" comes before "Conv_2"; the
state's (u, v) are then the JAX package's, element for element, and carry
across unchanged.  Each evaluation refreshes (u, v) by power iteration on the
detached weights and returns the sum of the estimated top singular values
u^T W v, differentiable in W.  `norm_scale_loss` sums max|scale| over the
VAE's GroupNorms.  Everything reads the fp32 master parameters.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

SNState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _sorted_layout(vae, kinds) -> List[str]:
    """Port module keys of the VAE's layers of `kinds`, in sorted JAX path
    order."""
    return [key for path, key in sorted((path, key) for key, path, kind in vae.jax_layout()
                                        if kind in kinds)]


def conv_matrices(vae) -> Dict[str, List[torch.Tensor]]:
    """The VAE's conv kernels as (out, kh * kw * in) matrices, grouped by
    shape, in the order above (differentiable in the parameters)."""
    params = dict(vae.named_parameters())
    groups: Dict[str, List[torch.Tensor]] = {}
    for key in _sorted_layout(vae, ("conv", "conv_nobias")):
        w = params[key + ".weight"]
        o, i, kh, kw = w.shape
        groups.setdefault(f"{o}x{kh * kw * i}", []).append(
            w.permute(0, 2, 3, 1).reshape(o, kh * kw * i))
    return groups


def _normalize(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """F.normalize's rule: x / max(||x||, eps) over the last axis."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def _power_iterations(w, u, v, n: int):
    for _ in range(n):
        v = _normalize(torch.einsum("nr,nrc->nc", u, w))
        u = _normalize(torch.einsum("nrc,nc->nr", w, v))
    return u, v


@torch.no_grad()
def init_sn_state(vae, generator: Optional[torch.Generator] = None, num_iter: int = 40,
                  draws: Optional[Iterator[torch.Tensor]] = None) -> SNState:
    """(u, v) per group: standard-normal draws (u, then v, group by group)
    from `generator`, or the next of `draws` when given, normalised, then
    `num_iter` power iterations."""
    state: SNState = {}
    for key, mats in conv_matrices(vae).items():
        w = torch.stack(mats).float()
        n, rows, cols = w.shape
        u, v = (next(draws).to(w.device) if draws is not None else
                torch.randn(shape, generator=generator, device=w.device)
                for shape in ((n, rows), (n, cols)))
        state[key] = _power_iterations(w, _normalize(u), _normalize(v), num_iter)
    return state


def spectral_norm_loss(vae, state: SNState, num_iter: int = 4) -> Tuple[torch.Tensor, SNState]:
    """-> (sum over groups of sum_n u_n^T W_n v_n, the refreshed state): (u,
    v) advance `num_iter` power iterations on the detached weights and
    carry no gradient."""
    loss = None
    new_state: SNState = {}
    for key, mats in conv_matrices(vae).items():
        w = torch.stack(mats)
        u, v = state[key]
        with torch.no_grad():
            u, v = _power_iterations(w.detach(), u, v, num_iter)
        sigma = torch.einsum("nr,nrc,nc->n", u, w, v).sum()
        loss = sigma if loss is None else loss + sigma
        new_state[key] = (u, v)
    return loss, new_state


def norm_scale_loss(vae) -> torch.Tensor:
    """Sum of max|scale| over the VAE's GroupNorms."""
    params = dict(vae.named_parameters())
    terms = [params[key + ".weight"].abs().max() for key in _sorted_layout(vae, ("gn",))]
    return torch.stack(terms).sum()
