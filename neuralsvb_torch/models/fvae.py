"""Frame-level and global conditional VAEs over mel-spectrograms, the
amateur -> professional latent maps and the technique classifier; port of
``neuralsvb_tpu/models/fvae.py`` (reference:
modules/fastspeech/fs2_vae.py:103-237, modules/voice_conversion/vae_models.py).
The SVB tasks run the posterior branch (``forward``) in training and
inference; ``infer`` decodes a prior sample. ``use_prior_glow`` puts a
residual coupling flow (``models/glow.py``) on the prior, with explicit
``glow_hidden``/``glow_kernel_size``/``glow_n_blocks``: the KL becomes
log q(z) - log p(flow(z)) and ``infer`` runs the flow in reverse (a
frame-level latent only: the JAX flow broadcasts a global latent against
the frame mask and fails). The BatchNorms follow the module's train/eval
mode.

Layout ``[B, C, T]``: a latent is ``[B, latent, T / stride]``, a global one
``[B, latent, 1]`` (the JAX package keeps ``[B, Tz, latent]``).
Reparameterization noise comes from an explicit ``torch.Generator``, or is
exactly zero with ``zero_noise``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import ddp
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
    """ConvTranspose pre-net -> WN -> out-proj (reference: fs2_vae.py:130-151);
    ``repeat_global`` first tiles a global latent to T / stride
    (reference: vae_models.py:124-127)."""

    def __init__(self, latent_channels, hidden_channels, out_channels, kernel_size,
                 n_layers, gin_channels, stride: int = 4, repeat_global: bool = True):
        super().__init__()
        self.stride = stride
        self.repeat_global = repeat_global
        self.pre_net = nn.Sequential(nn.ConvTranspose1d(
            latent_channels, hidden_channels, stride, stride=stride))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, z, x_mask, g):
        """z [B, latent, 1] (global) or [B, latent, T / stride]; x_mask
        [B, 1, T]; g [B, gin, T] -> [B, out, T]."""
        x = z.repeat_interleave(g.shape[-1] // self.stride, dim=-1) if self.repeat_global else z
        x = self.pre_net(x) * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return self.out_proj(x)


class FVAE(nn.Module):
    """Conditional VAE: ``global_latent`` gives GlobalFVAE (one latent per
    utterance), else TMPFVAE (one per ``stride`` frames) in the reference
    (vae_models.py:11-48,133-150); the posterior (non-infer) branch."""

    def __init__(self, in_out_channels, hidden_channels, latent_size, kernel_size,
                 enc_n_layers, dec_n_layers, gin_channels, stride: int = 4,
                 global_latent: bool = True, use_prior_glow: bool = False,
                 glow_hidden: Optional[int] = None, glow_kernel_size: Optional[int] = None,
                 glow_n_blocks: Optional[int] = None):
        super().__init__()
        self.stride = stride
        self.latent_size = latent_size
        self.global_latent = global_latent
        self.use_prior_glow = use_prior_glow
        if use_prior_glow:
            if None in (glow_hidden, glow_kernel_size, glow_n_blocks):
                raise ValueError("use_prior_glow needs glow_hidden, glow_kernel_size and "
                                 "glow_n_blocks (neuralsvb_tpu/models/fvae.py:179-183)")
            from .glow import ResidualCouplingBlock
            self.prior_flow = ResidualCouplingBlock(latent_size, glow_hidden,
                                                    glow_kernel_size, 1, glow_n_blocks, 4,
                                                    gin_channels=gin_channels)
        self.g_pre_net = nn.Sequential(nn.Conv1d(
            gin_channels, gin_channels, 2 * stride, stride=stride,
            padding=stride // 2))
        enc_cls = GlobalFVAEEncoder if global_latent else FVAEEncoder
        self.encoder = enc_cls(in_out_channels, hidden_channels, latent_size,
                               kernel_size, enc_n_layers, gin_channels, stride)
        self.decoder = FVAEDecoder(latent_size, hidden_channels, in_out_channels,
                                   kernel_size, dec_n_layers, gin_channels, stride,
                                   repeat_global=global_latent)

    def forward(self, x, x_mask, g, generator: Optional[torch.Generator] = None,
                zero_noise=False, prior_mean: float = 0.0):
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, T] ->
        dict(mel_out, kl, m_q, logs_q, x_mask_sqz, z_q, z_p); the KL is
        against the prior N(prior_mean, 1), through the prior flow with
        ``use_prior_glow`` (``z_p`` its image of ``z_q``, else None)."""
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
        z_p = None
        if self.use_prior_glow:
            z_p, _ = self.prior_flow(z_q, x_mask_sqz, g_sqz)
            kl_elem = (normal_log_prob(z_q, m_q, logs_q)
                       - normal_log_prob(z_p, prior_mean, 0.0))
        else:
            kl_elem = gaussian_kl(m_q, logs_q, prior_mean, 0.0)  # [B, L, Tz]
        # length-weighted batch mean, as the reference computes it (a global
        # latent's [B, L, 1] broadcasts against the frame mask)
        loss_kl = (ddp.all_sum((kl_elem * x_mask_sqz).sum()) / ddp.all_sum(x_mask_sqz.sum())
                   / kl_elem.shape[1])
        return dict(mel_out=x_recon, kl=loss_kl, m_q=m_q, logs_q=logs_q,
                    x_mask_sqz=x_mask_sqz, z_q=z_q, z_p=z_p)

    def infer(self, g, x_mask=None, generator: Optional[torch.Generator] = None,
              zero_noise=False, prior_mean: float = 0.0):
        """A prior sample decoded: g [B, gin, T]; x_mask [B, 1, T] (None: every
        frame) -> (x_recon [B, C, T], z_p [B, latent, Tz]); the prior flow
        runs in reverse with ``use_prior_glow`` (JAX: fvae.py:222-233)."""
        g_sqz = self.g_pre_net(g)
        Tz = 1 if self.global_latent else g_sqz.shape[-1]
        z_p = prior_mean + draw_normal((g.shape[0], self.latent_size, Tz), g, generator,
                                       zero_noise)
        if self.use_prior_glow:
            z_p, _ = self.prior_flow(z_p, torch.ones_like(z_p[:, :1]), g_sqz, reverse=True)
        x_mask = torch.ones_like(g[:, :1]) if x_mask is None else x_mask
        return self.decoder(z_p, x_mask, g), z_p


class LatentMap(nn.Module):
    """Frame-level latent mapping: three k3 convs (BN + ReLU between) on the
    latent plus a projected speaker style (reference: vae_models.py:51-75).
    The style projection ends at 16 channels, so only a 16-channel latent
    adds to it, as in the JAX package."""

    def __init__(self, latent_size: int, style_channels: int, kernel_size: int = 3,
                 spk_hidden: int = 64, spk_out: int = 16):
        super().__init__()
        L, pad = latent_size, kernel_size // 2
        self.spk_proj = nn.Sequential(
            nn.Conv1d(style_channels, spk_hidden, kernel_size, padding=pad), nn.ReLU(),
            nn.Conv1d(spk_hidden, spk_out, kernel_size, padding=pad))
        self.convs = nn.Sequential(
            nn.Conv1d(L, L, kernel_size, padding=pad), BatchNorm1d(L, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L, L, kernel_size, padding=pad), BatchNorm1d(L, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L, L, kernel_size, padding=pad))

    def forward(self, x, style):
        """x [B, L, Tz]; style [B, H, T] (its first Tz frames are read) ->
        [B, L, Tz]."""
        return self.convs(x + self.spk_proj(style[:, :, : x.shape[-1]]))


class GlobalLatentMap(LatentMap):
    """Global latent mapping of 1x1 convs with a projected speaker style
    (reference: vae_models.py:149-172); x [B, L, 1]."""

    def __init__(self, latent_size: int, style_channels: int):
        super().__init__(latent_size, style_channels, kernel_size=1,
                         spk_hidden=latent_size, spk_out=latent_size)


class TechClassifier(nn.Module):
    """Latent -> amateur/professional logits: 1x1 convs with a projected
    speaker style added (reference: vae_models.py:238-261; JAX:
    fvae.py:278-295). No task of either package builds it."""

    def __init__(self, latent_size: int, style_channels: int):
        super().__init__()
        L = latent_size
        self.spk_proj = nn.Sequential(nn.Conv1d(style_channels, L, 1), nn.ReLU(),
                                      nn.Conv1d(L, L, 1))
        self.convs = nn.Sequential(
            nn.Conv1d(L, L // 2, 1), BatchNorm1d(L // 2, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L // 2, L // 4, 1), BatchNorm1d(L // 4, eps=BN_EPS), nn.ReLU(),
            nn.Conv1d(L // 4, 2, 1))

    def forward(self, x, style):
        """x [B, L, Tz]; style [B, H, T] (its first Tz frames are read) ->
        the first frame's logits [B, 2]."""
        return self.convs(x + self.spk_proj(style[:, :, : x.shape[-1]]))[:, :, 0]
