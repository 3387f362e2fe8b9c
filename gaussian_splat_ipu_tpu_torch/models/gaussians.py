"""Gaussian scene model (torch port of
gaussian_splat_ipu_tpu/models/gaussians.py).

Standard 3DGS parameters, structure-of-arrays:
  means       (N, 3) world-space centres
  log_scales  (N, 3) log of per-axis scale
  quats       (N, 4) rotations (w, x, y, z)
  opacities   (N,)   raw opacity (sigmoid at render time when
                     RasterConfig.sigmoid_opacity)
  sh          (N, K, 3) SH coefficients, K = (degree+1)^2; sh[:, 0] = f_dc
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

# Field order = parameters() order = the reference pytree's leaf order.
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


class GaussianModel(nn.Module):
    """The five parameter tensors of a scene. They are created with
    requires_grad=False, so rendering builds no graph; `trainable()` gives
    the copy a trainer differentiates."""

    def __init__(self, means, log_scales, quats, opacities, sh,
                 requires_grad: bool = False):
        super().__init__()
        for name, value in zip(FIELDS, (means, log_scales, quats,
                                         opacities, sh)):
            setattr(self, name, nn.Parameter(
                torch.as_tensor(value, dtype=torch.float32),
                requires_grad=requires_grad))

    def trainable(self) -> "GaussianModel":
        """A copy whose parameters require grad (own storage, so training
        it leaves this model as it is)."""
        return GaussianModel(*(getattr(self, k).detach().clone()
                               for k in FIELDS), requires_grad=True)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(math.isqrt(self.sh.shape[1])) - 1

    @property
    def device(self) -> torch.device:
        return self.means.device

    def pad_to(self, n: int) -> "GaussianModel":
        """Pad to n gaussians; padding has opacity -30 and log-scale -30,
        so it is culled."""
        cur = self.num_gaussians
        if cur == n:
            return self
        if n < cur:
            raise ValueError(f"pad_to({n}) below the {cur} gaussians held")
        pad = n - cur

        def _pad(x, fill=0.0):
            return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                            dtype=x.dtype,
                                            device=x.device)])

        ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float32,
                             device=self.device).expand(pad, 4)
        return GaussianModel(_pad(self.means), _pad(self.log_scales, -30.0),
                             torch.cat([self.quats, ident]),
                             _pad(self.opacities, -30.0), _pad(self.sh))

    def with_sh_degree(self, degree: int) -> "GaussianModel":
        """Resize the SH axis to (degree+1)^2 bands: new bands start at
        zero, extra bands are truncated."""
        k = (degree + 1) ** 2
        cur = self.sh.shape[1]
        if k == cur:
            return self
        if k < cur:
            sh = self.sh[:, :k]
        else:
            sh = torch.cat([self.sh, torch.zeros(
                (self.sh.shape[0], k - cur, 3), dtype=self.sh.dtype,
                device=self.device)], dim=1)
        return GaussianModel(self.means, self.log_scales, self.quats,
                             self.opacities, sh)

    @classmethod
    def from_numpy(cls, params: dict, device) -> "GaussianModel":
        """Build from numpy arrays keyed means, log_scales, quats,
        opacities and sh — the bridge that carries JAX parameters across,
        so that both packages compute on identical weights."""
        return cls(*(torch.tensor(np.asarray(params[k], np.float32),
                                  device=device) for k in FIELDS))

    @classmethod
    def create(cls, means, log_scales, quats, opacities, f_dc,
               f_rest: Optional[np.ndarray] = None, sh_degree: int = 0, *,
               device) -> "GaussianModel":
        """Assemble from raw arrays (parsed PLY fields). f_dc: (N, 3);
        f_rest: (N, K-1, 3) higher-order coefficients or None."""
        n = means.shape[0]
        k = (sh_degree + 1) ** 2
        sh = np.zeros((n, k, 3), np.float32)
        sh[:, 0] = f_dc
        if f_rest is not None and k > 1:
            sh[:, 1:] = f_rest[:, :k - 1]
        return cls.from_numpy(dict(means=means, log_scales=log_scales,
                                   quats=quats, opacities=opacities, sh=sh),
                              device)

    @classmethod
    def random(cls, n: int, *, generator: torch.Generator, device,
               sh_degree: int = 0, extent: float = 1.0) -> "GaussianModel":
        """Random synthetic scene with the reference's distributions
        (models/gaussians.py:159-172); torch draws other bits than JAX.
        The generator must live on `device`."""
        kk = (sh_degree + 1) ** 2

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=device)
            return u * (hi - lo) + lo

        return cls(
            means=uniform((n, 3), -extent, extent),
            log_scales=uniform((n, 3), -5.5, -3.5) + math.log(extent),
            quats=torch.randn((n, 4), generator=generator, device=device),
            opacities=uniform((n,), -2.0, 4.0),
            sh=uniform((n, kk, 3), -1.0, 1.0),
        )

    def to_numpy(self) -> dict:
        """The five parameter arrays as numpy, keyed as from_numpy takes
        them."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}


def center_and_flip(points: np.ndarray) -> np.ndarray:
    """Centre the cloud on its bounding-box midpoint and negate z
    (reference src/main/splat.cpp:92-100)."""
    pts = np.asarray(points, np.float32)
    bb_min, bb_max = pts.min(0), pts.max(0)
    pts = pts - (bb_min + bb_max) * 0.5
    pts[:, 2] = -pts[:, 2]
    return pts
