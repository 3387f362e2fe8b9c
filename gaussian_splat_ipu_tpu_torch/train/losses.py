"""Image losses for training (torch port of
gaussian_splat_ipu_tpu/train/losses.py:19-100): the standard 3DGS recipe
(1 - lambda) * L1 + lambda * (1 - SSIM), SSIM over an 11x11 Gaussian
window (sigma 1.5) as a separable VALID depthwise blur. Images are
(H, W, C) f32, as the reference's."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(mse, 1e-12))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    """The normalised 1D window, computed in f32 as the reference's numpy
    version is."""
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur of an (H, W, C) image: two rank-1
    VALID convolutions with groups=C."""
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                          # (1, C, H, W)
    k = window.numel()
    x = F.conv2d(x, window.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, window.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair. Differentiable. On CUDA the
    convolutions follow torch.backends.cudnn.allow_tf32; the trainer's
    callers turn it off, as the reference computes in full f32."""
    w = _gaussian_window(window_size, sigma, pred.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_p = _blur(pred, w)
    mu_t = _blur(target, w)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sig_p = _blur(pred * pred, w) - mu_pp
    sig_t = _blur(target * target, w) - mu_tt
    sig_pt = _blur(pred * target, w) - mu_pt

    num = (2.0 * mu_pt + c1) * (2.0 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return torch.mean(num / den)


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 1.0 - ssim(pred, target)


def render_loss(pred: torch.Tensor, target: torch.Tensor,
                ssim_weight: float = 0.2) -> torch.Tensor:
    """Standard 3DGS photometric loss on the RGB channels."""
    rgb_p = pred[..., :3]
    rgb_t = target[..., :3]
    loss = (1.0 - ssim_weight) * l1(rgb_p, rgb_t)
    if ssim_weight > 0.0:
        loss = loss + ssim_weight * dssim(rgb_p, rgb_t)
    return loss
