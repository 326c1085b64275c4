"""The global conditional VAE over mel-spectrograms and the amateur ->
professional latent map of the flagship; port of the global-latent path
of ``neuralsvb_tpu/models/fvae.py`` (reference:
modules/fastspeech/fs2_vae.py:103-151, modules/voice_conversion/vae_models.py:11-172).
The SVB tasks run the posterior branch in training and inference. The
BatchNorms follow the module's train/eval mode.

Layout ``[B, C, T]``: the global latent is ``[B, latent, 1]`` (the JAX
package keeps ``[B, Tz, latent]``). Reparameterization noise comes from an
explicit ``torch.Generator``, or is exactly zero with ``zero_noise``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BN_EPS, BatchNorm1d, draw_normal
from .wn import WN


def gaussian_kl(m_q, logs_q, m_p=0.0, logs_p=0.0):
    """KL(N(m_q, e^logs_q) || N(m_p, e^logs_p)), elementwise."""
    logs_p = torch.as_tensor(logs_p, dtype=m_q.dtype, device=m_q.device)
    return (logs_p - logs_q
            + (torch.exp(2 * logs_q) + (m_q - m_p) ** 2) / (2 * torch.exp(2 * logs_p))
            - 0.5)


def normal_log_prob(x, mean, logs):
    """log N(x; mean, e^logs), elementwise."""
    if not torch.is_tensor(logs):  # a constant scale, as the prior's 0
        logs = torch.tensor(logs, dtype=x.dtype, device=x.device)
    return -0.5 * (math.log(2 * math.pi) + 2 * logs + (x - mean) ** 2 / torch.exp(2 * logs))


class FVAEEncoder(nn.Module):
    """Strided conv pre-net -> WN -> out-proj: a frame-level posterior, one
    latent per ``stride`` frames (reference: fs2_vae.py:103-127)."""

    def __init__(self, in_channels, hidden_channels, latent_channels, kernel_size,
                 n_layers, gin_channels, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.latent_channels = latent_channels
        self.pre_net = nn.Sequential(nn.Conv1d(
            in_channels, hidden_channels, 2 * stride, stride=stride,
            padding=stride // 2))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = nn.Conv1d(hidden_channels, 2 * latent_channels, 1)

    def project(self, x, x_mask, g):
        """-> the out-proj [B, 2 latent, T / stride] and the strided mask."""
        x = self.pre_net(x)
        x_mask = x_mask[:, :, ::self.stride][:, :, : x.shape[-1]]
        x = x * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return self.out_proj(x), x_mask

    def sample(self, h, generator, zero_noise):
        m, logs = h.split(self.latent_channels, dim=1)
        z = m + draw_normal(m.shape, m, generator, zero_noise) * torch.exp(logs)
        return z, m, logs

    def forward(self, x, x_mask, g, generator=None, zero_noise=False):
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, T / stride] ->
        (z, m, logs) [B, latent, T / stride] and the strided mask
        [B, 1, T / stride]. Padded latent frames hold the out-proj's bias."""
        h, x_mask = self.project(x, x_mask, g)
        return (*self.sample(h, generator, zero_noise), x_mask)


class GlobalFVAEEncoder(FVAEEncoder):
    """``FVAEEncoder``, then three stride-2 VALID conv poolings and a
    temporal mean -> one global latent (reference: vae_models.py:81-105)."""

    def __init__(self, in_channels, hidden_channels, latent_channels, kernel_size,
                 n_layers, gin_channels, stride: int = 4):
        super().__init__(in_channels, hidden_channels, latent_channels, kernel_size,
                         n_layers, gin_channels, stride)
        L2 = 2 * latent_channels
        self.poolings = nn.Sequential(
            nn.Conv1d(L2, L2, 3, stride=2), nn.ReLU(), BatchNorm1d(L2, eps=BN_EPS),
            nn.Conv1d(L2, L2, 3, stride=2), nn.ReLU(), BatchNorm1d(L2, eps=BN_EPS),
            nn.Conv1d(L2, L2, 3, stride=2))

    def forward(self, x, x_mask, g, generator=None, zero_noise=False):
        """As ``FVAEEncoder``, with (z, m, logs) [B, latent, 1]."""
        h, x_mask = self.project(x, x_mask, g)
        # mask the biased out-proj at padded frames, so a clip shorter than
        # the batch pools the zeros its unpadded run would see
        h = h * x_mask
        if h.shape[-1] < 15:  # three VALID stride-2 poolings need 15 frames
            h = F.pad(h, (0, 15 - h.shape[-1]))
        # the unpadded run averages exactly L3 pooled positions: restrict the
        # mean to them so the latent does not depend on the padding
        L = x_mask.sum((1, 2)).long().clamp_min(15)
        for i in range(3):
            L = (L - 3) // 2 + 1
        h = self.poolings(h)
        wmask = (torch.arange(h.shape[-1], device=h.device)[None, :]
                 < L[:, None])[:, None, :].to(h.dtype)
        h = (h * wmask).sum(-1, keepdim=True) / L.clamp_min(1)[:, None, None].to(h.dtype)
        return (*self.sample(h, generator, zero_noise), x_mask)


class FVAEDecoder(nn.Module):
    """The global latent tiled to T / stride (reference:
    vae_models.py:124-127), then ConvTranspose pre-net -> WN -> out-proj
    (reference: fs2_vae.py:130-151)."""

    def __init__(self, latent_channels, hidden_channels, out_channels, kernel_size,
                 n_layers, gin_channels, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.pre_net = nn.Sequential(nn.ConvTranspose1d(
            latent_channels, hidden_channels, stride, stride=stride))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, z, x_mask, g):
        """z [B, latent, 1]; x_mask [B, 1, T]; g [B, gin, T] -> [B, out, T]."""
        x = z.repeat_interleave(g.shape[-1] // self.stride, dim=-1)
        x = self.pre_net(x) * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return self.out_proj(x)


class FVAE(nn.Module):
    """GlobalFVAE of the reference (vae_models.py:11-48,133-150): one latent
    per utterance; the posterior branch."""

    def __init__(self, in_out_channels, hidden_channels, latent_size, kernel_size,
                 enc_n_layers, dec_n_layers, gin_channels, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.latent_size = latent_size
        self.g_pre_net = nn.Sequential(nn.Conv1d(
            gin_channels, gin_channels, 2 * stride, stride=stride,
            padding=stride // 2))
        self.encoder = GlobalFVAEEncoder(in_out_channels, hidden_channels, latent_size,
                                         kernel_size, enc_n_layers, gin_channels, stride)
        self.decoder = FVAEDecoder(latent_size, hidden_channels, in_out_channels,
                                   kernel_size, dec_n_layers, gin_channels, stride)

    def forward(self, x, x_mask, g, generator: Optional[torch.Generator] = None,
                zero_noise=False):
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, T] ->
        dict(mel_out, kl, m_q, logs_q, x_mask_sqz, z_q); the KL is against
        the prior N(0, 1)."""
        if x.shape[-1] % self.stride:
            raise ValueError(f"FVAE input frames ({x.shape[-1]}) must be a "
                             f"multiple of the latent stride ({self.stride})")
        g_sqz = self.g_pre_net(g)
        z_q, m_q, logs_q, x_mask_sqz = self.encoder(x, x_mask, g_sqz, generator,
                                                    zero_noise)
        x_recon = self.decoder(z_q, x_mask, g)
        # guard against non-positive posterior scales (vae_models.py:24-30)
        s = torch.exp(logs_q)
        logs_q = torch.where(torch.isfinite(s) & (s > 0), logs_q,
                             torch.zeros_like(logs_q))
        kl_elem = gaussian_kl(m_q, logs_q)  # [B, L, 1]
        # length-weighted batch mean, as the reference computes it (the
        # global latent's [B, L, 1] broadcasts against the frame mask)
        loss_kl = (((kl_elem * x_mask_sqz).sum()) / (x_mask_sqz.sum())
                   / kl_elem.shape[1])
        return dict(mel_out=x_recon, kl=loss_kl, m_q=m_q, logs_q=logs_q,
                    x_mask_sqz=x_mask_sqz, z_q=z_q)


class GlobalLatentMap(nn.Module):
    """Global latent mapping of 1x1 convs (BN + ReLU between) on the latent
    plus a projected speaker style (reference: vae_models.py:51-75,149-172)."""

    def __init__(self, latent_size: int, style_channels: int):
        super().__init__()
        L = latent_size
        self.spk_proj = nn.Sequential(nn.Conv1d(style_channels, L, 1), nn.ReLU(),
                                      nn.Conv1d(L, L, 1))
        self.convs = nn.Sequential(
            nn.Conv1d(L, L, 1), BatchNorm1d(L, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L, L, 1), BatchNorm1d(L, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L, L, 1))

    def forward(self, x, style):
        """x [B, L, 1]; style [B, H, T] (its first frame is read) -> [B, L, 1]."""
        return self.convs(x + self.spk_proj(style[:, :, : x.shape[-1]]))
