"""Windowed SSIM for the mel loss; port of ``neuralsvb_tpu/ops/ssim.py``
(reference: modules/commons/ssim.py:306-352).

An 11-tap gaussian window (sigma 1.5) applied separably, first over the
rows then over the columns, with SAME zero padding; C1 = 0.01^2,
C2 = 0.03^2. ``size_average=False`` returns the map.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable blur of [B, 1, H, W] with zero padding."""
    k = taps.numel()
    x = F.conv2d(x, taps.view(1, 1, k, 1), padding=(k // 2, 0))
    return F.conv2d(x, taps.view(1, 1, 1, k), padding=(0, k // 2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """img1/img2 [B, 1, H, W] -> the mean SSIM, or the map [B, H, W]."""
    taps = torch.from_numpy(gaussian_1d(window_size)).to(img1.device, img1.dtype)
    mu1, mu2 = _blur(img1, taps), _blur(img2, taps)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, taps) - mu1_sq
    sigma2_sq = _blur(img2 * img2, taps) - mu2_sq
    sigma12 = _blur(img1 * img2, taps) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean() if size_average else ssim_map[:, 0]
