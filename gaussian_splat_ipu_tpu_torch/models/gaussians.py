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

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from gaussian_splat_ipu_tpu_torch.ops.sh import SH_C0

# Field order = parameters() order = the reference pytree's leaf order.
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


class GaussianModel(nn.Module):
    """The five parameter tensors of a scene. They are created with
    requires_grad=False, so rendering builds no graph; `trainable()` gives
    the copy a trainer differentiates."""

    def __init__(self, means, log_scales, quats, opacities, sh,
                 requires_grad: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, value in zip(FIELDS, (means, log_scales, quats,
                                         opacities, sh)):
            setattr(self, name, nn.Parameter(
                torch.as_tensor(value, dtype=dtype),
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

    def astype(self, dtype: torch.dtype) -> "GaussianModel":
        """The five fields cast to `dtype` (e.g. torch.bfloat16)."""
        return GaussianModel(*(getattr(self, k).detach().to(dtype)
                               for k in FIELDS), dtype=dtype)

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
    def from_points(cls, xyz: np.ndarray, rgb: np.ndarray,
                    sh_degree: int = 0, opacity: float = 0.1, knn: int = 3,
                    *, device) -> "GaussianModel":
        """The standard 3DGS initialisation from an SfM point cloud
        (reference models/gaussians.py:121-156): one isotropic gaussian per
        point, its scale the mean distance to the `knn` nearest neighbours
        (at least 1e-7), its colour the SH dc band, its opacity a uniform
        post-sigmoid `opacity`."""
        xyz = np.asarray(xyz, np.float32)
        rgb = np.asarray(rgb, np.float32)
        n = xyz.shape[0]
        if n == 0:
            raise ValueError("from_points: empty point cloud")
        means = torch.tensor(xyz, device=device)
        dist = torch.clamp_min(mean_knn_distance(means, k=knn), 1e-7)
        sh = np.zeros((n, (sh_degree + 1) ** 2, 3), np.float32)
        sh[:, 0] = (rgb - 0.5) / SH_C0      # inverts colour_from_dc
        p = float(np.clip(opacity, 1e-4, 1.0 - 1e-4))
        return cls(
            means=means,
            log_scales=torch.log(dist)[:, None].repeat(1, 3),
            quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                               device=device).repeat(n, 1),
            opacities=torch.full((n,), float(np.log(p / (1.0 - p))),
                                 dtype=torch.float32, device=device),
            sh=torch.tensor(sh, device=device))

    @classmethod
    def random(cls, n: int, *, generator: torch.Generator, device,
               sh_degree: int = 0, extent: float = 1.0) -> "GaussianModel":
        """Random synthetic scene with the reference's distributions
        (models/gaussians.py:159-172); torch draws other bits than JAX.
        The generator must live on `device`."""
        kk = (sh_degree + 1) ** 2
        uniform = functools.partial(_uniform, generator, device)
        return cls(
            means=uniform((n, 3), -extent, extent),
            log_scales=uniform((n, 3), -5.5, -3.5) + math.log(extent),
            quats=torch.randn((n, 4), generator=generator, device=device),
            opacities=uniform((n,), -2.0, 4.0),
            sh=uniform((n, kk, 3), -1.0, 1.0),
        )

    @classmethod
    def clustered(cls, n: int, *, generator: torch.Generator, device,
                  n_clusters: int = 64, sh_degree: int = 0,
                  extent: float = 1.0) -> "GaussianModel":
        """Clustered synthetic scene with the reference's distributions
        (models/gaussians.py:175-208): n_clusters centres uniform in
        +-0.8 extent, each with a log-uniform spread in [0.02, 0.3] extent;
        means at a uniformly drawn centre plus a normal offset times its
        spread; log-scales N(-4.5 + ln extent, 0.6); normal quats;
        opacities U(-4, 6); SH U(-1, 1). Each draw comes from `generator`
        in turn (the reference draws its centres and SH from one key);
        torch draws other bits than JAX. The generator must live on
        `device`."""
        kk = (sh_degree + 1) ** 2
        uniform = functools.partial(_uniform, generator, device)

        def normal(shape):
            return torch.randn(shape, generator=generator, device=device)

        centers = uniform((n_clusters, 3), -0.8 * extent, 0.8 * extent)
        spread = torch.exp(uniform((n_clusters,), math.log(0.02 * extent),
                                   math.log(0.3 * extent)))
        assign = torch.randint(0, n_clusters, (n,), generator=generator,
                               device=device)
        means = centers[assign] + normal((n, 3)) * spread[assign][:, None]
        return cls(
            means=means,
            log_scales=normal((n, 3)) * 0.6 - 4.5 + math.log(extent),
            quats=normal((n, 4)),
            opacities=uniform((n,), -4.0, 6.0),
            sh=uniform((n, kk, 3), -1.0, 1.0),
        )

    def to_numpy(self) -> dict:
        """The five parameter arrays as numpy, keyed as from_numpy takes
        them."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}


def _uniform(generator: torch.Generator, device, shape, lo: float,
             hi: float) -> torch.Tensor:
    """U(lo, hi) f32 draws of `shape` from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def mean_knn_distance(xyz: torch.Tensor, k: int = 3,
                      chunk: int = 1024) -> torch.Tensor:
    """Mean distance to the k nearest neighbours of every point, (N,) f32
    (reference models/gaussians.py:209-241). Exact and chunked: each row
    chunk's (chunk, N) squared distances are |a|^2 + |b|^2 - 2 a.b, one
    matmul, and the k + 1 smallest (self included, at about 0) are kept."""
    n = xyz.shape[0]
    if n == 1:
        return torch.zeros((1,), dtype=torch.float32, device=xyz.device)
    k_eff = min(k, max(n - 1, 1))
    sq = torch.sum(xyz * xyz, dim=-1)
    out = []
    for lo in range(0, n, chunk):
        r = xyz[lo:lo + chunk]
        d2 = sq[lo:lo + chunk, None] + sq[None, :] - 2.0 * (r @ xyz.T)
        neg, _ = torch.topk(-d2, k_eff + 1, dim=1)
        d2k = torch.clamp_min(-neg[:, 1:], 0.0)          # drop self
        out.append(torch.mean(torch.sqrt(d2k), dim=-1))
    return torch.cat(out)


def center_and_flip(points: np.ndarray) -> np.ndarray:
    """Centre the cloud on its bounding-box midpoint and negate z
    (reference src/main/splat.cpp:92-100)."""
    pts = np.asarray(points, np.float32)
    bb_min, bb_max = pts.min(0), pts.max(0)
    pts = pts - (bb_min + bb_max) * 0.5
    pts[:, 2] = -pts[:, 2]
    return pts
