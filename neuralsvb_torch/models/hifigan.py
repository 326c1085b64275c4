"""HiFiGAN generator with NSF sine excitation; port of the generator of
``neuralsvb_tpu/models/hifigan.py`` (reference: modules/hifigan/hifigan.py).

conv_pre -> N x (leaky_relu -> ConvTranspose up -> + NSF source through a
strided noise_conv -> mean of the multi-kernel ResBlocks) -> leaky_relu ->
conv_post -> tanh. With ``resblock == "1"`` each stage's ResBlock cluster
runs through ``ops.fused_resblock.fused_resblock_cluster``: the CUDA kernel
on the card, its plain PyTorch twin on the CPU. ``mm_dtype`` is that op's
matmul operand dtype; ``None`` picks by device (bf16 on the card, f32 on
the CPU), as the JAX generator picks bf16 on the TPU. Weight norm is folded
into plain convs (the reference removes it at inference).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_resblock import (fused_resblock_cluster, make_spec, pack_tower,
                                  resolve_mm_dtype)
from .nsf import SourceModuleHnNSF

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size,
                      padding=get_padding(kernel_size)) for _ in dilation])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = c2(F.leaky_relu(xt, LRELU_SLOPE)) + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation])

    def forward(self, x):
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class HifiGanGenerator(nn.Module):
    """Config keys follow the reference yaml (upsample_rates, ...).

    ``mm_dtype`` (attribute): the ResBlock cluster's matmul operand dtype,
    f32, bf16 or ``None`` (by device)."""

    mm_dtype: Optional[torch.dtype] = None

    def __init__(self, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_pitch_embed: bool = True, audio_sample_rate: int = 22050,
                 num_mels: int = 80, harmonic_num: int = 8, c_out: int = 1):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.hop = int(np.prod(upsample_rates))
        self.num_mels = num_mels
        self.resblock = str(resblock)
        self.num_kernels = len(resblock_kernel_sizes)
        self.use_pitch_embed = use_pitch_embed
        self.spec = make_spec(resblock_kernel_sizes, resblock_dilation_sizes)
        ch0 = upsample_initial_channel
        if use_pitch_embed:
            self.m_source = SourceModuleHnNSF(audio_sample_rate, harmonic_num)
            self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(num_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        res_cls = ResBlock1 if self.resblock == "1" else ResBlock2
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_cur = ch0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch0 // (2 ** i), c_cur, k, u,
                                               padding=(k - u) // 2))
            if use_pitch_embed:
                if i + 1 < len(upsample_rates):
                    s = int(np.prod(upsample_rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 2 * s, stride=s,
                                                      padding=s // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(c_cur, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(c_cur, c_out, 7, padding=3)
        self._packed: Dict[torch.dtype, List[List[torch.Tensor]]] = {}

    # -- packed cluster weights --------------------------------------------
    def _mm_dtype(self) -> torch.dtype:
        return resolve_mm_dtype(self.mm_dtype, self.conv_pre.weight.device)

    def _pack(self, mm_dtype: torch.dtype) -> List[List[torch.Tensor]]:
        """Per stage: flat [wa, ba, wb, bb] per tower in the kernel layout."""
        out = []
        for i in range(len(self.ups)):
            ws: List[torch.Tensor] = []
            for j in range(self.num_kernels):
                rb = self.resblocks[i * self.num_kernels + j]
                ws += pack_tower(rb.convs1, rb.convs2, mm_dtype)
            out.append(ws)
        return out

    def pack_resblocks(self) -> None:
        """Pack the ResBlock weights once for the cluster kernel in the
        current mm dtype (after the weights are loaded and on their
        device)."""
        with torch.no_grad():
            dtype = self._mm_dtype()
            self._packed[dtype] = self._pack(dtype)

    def _apply(self, fn, *args, **kwargs):
        self._packed = {}  # .to()/.cuda() moved the weights
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = {}
        return super()._load_from_state_dict(*args, **kwargs)

    def _stage_weights(self, mm_dtype: torch.dtype) -> List[List[torch.Tensor]]:
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.resblocks.parameters()):
            # differentiable f32 packing for training; the op rounds operands
            return self._pack(torch.float32)
        if mm_dtype not in self._packed:
            self.pack_resblocks()
        return self._packed[mm_dtype]

    # ----------------------------------------------------------------------
    def forward(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                zero_noise: bool = False, rand_ini=None, noise=None):
        """mel [B, T, num_mels]; f0 [B, T] Hz (0 = unvoiced) -> wav [B, T*hop].
        ``generator`` / ``zero_noise`` / ``rand_ini`` / ``noise`` drive the
        NSF source's random draws (see ``SineGen``)."""
        har_source = None
        if self.use_pitch_embed and f0 is not None:
            # the phase cumsum runs over T*hop samples and stays float32
            f0_up = f0.to(torch.float32).repeat_interleave(self.hop, dim=1)[:, None]
            har_source, _, _ = self.m_source(f0_up, generator, zero_noise,
                                             rand_ini, noise)
            har_source = har_source.to(mel.dtype)  # [B, 1, L]
        x = self.conv_pre(mel.transpose(1, 2))
        mm_dtype = self._mm_dtype()
        packed = self._stage_weights(mm_dtype) if self.resblock == "1" else None
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if har_source is not None:
                x = x + self.noise_convs[i](har_source)[:, :, : x.shape[-1]]
            if packed is not None:
                x = fused_resblock_cluster(x, packed[i], self.spec, mm_dtype)
            else:
                blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
                x = sum(rb(x) for rb in blocks) / self.num_kernels
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0]
