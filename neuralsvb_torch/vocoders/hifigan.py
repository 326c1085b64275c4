"""HiFiGAN-NSF inference wrapper; port of ``neuralsvb_tpu/vocoders/hifigan.py``
(reference: vocoders/hifigan.py:17-76).

``spec2wav`` pads the frame count up to a fixed bucket (as the JAX package
does, so outputs match it; on the card it keeps the set of kernel shapes
small) and runs the generator on the vocoder's device; the NSF source and
the ResBlock cluster kernel run there too.

Loading order (``<vocoder_ckpt>/config.yaml`` overrides the generator keys):
1. ``<vocoder_ckpt>/params.msgpack``, the JAX package's flax params, through
   ``convert/msgpack_ckpt.py`` and ``hifigan_from_jax``;
2. the newest ``<vocoder_ckpt>/model_ckpt_steps_*.ckpt``: a PyTorch
   checkpoint under the reference names, or a JAX package checkpoint (its
   ``state.params``);
3. otherwise seeded random init with a loud warning.

``vocoder_compute_dtype: bfloat16`` (``compute_dtype`` when it is not set)
runs the whole generator in bf16 and returns f32, as the JAX vocoder does:
the weights are cast once, the mel enters as bf16, f0 and the NSF phase
cumsum stay f32 and the sine source is cast to bf16 before ``noise_conv``,
so every activation after the injection is bf16 and the ResBlock kernel
takes them as they are (``ops/fused_resblock.py``).

``vocoder_denoise_c > 0`` denoises every wav by spectral subtraction of
that magnitude on the vocoder's device (``ops/stft.py``
``spectral_subtract``; JAX: ``vocoders/hifigan.py:133-135``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import yaml

from ..convert import msgpack_ckpt
from ..convert.checkpoint import load_into, load_state_dict, newest_checkpoint
from ..convert.jax2torch import hifigan_from_jax
from ..hparams import hparams as global_hparams
from ..hparams import resolve_device
from ..models.hifigan import HifiGanGenerator
from ..ops.stft import spectral_subtract
from .base import BaseVocoder, register_vocoder

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(t: int) -> int:
    for b in BUCKETS:
        if t <= b:
            return b
    return ((t + 1023) // 1024) * 1024


def load_hifigan(base_dir: str, hp: dict, device: torch.device):
    """Returns (model in eval mode on ``device``, config dict, loaded?)."""
    config = dict(hp)
    cfg_path = os.path.join(base_dir, "config.yaml")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config.update(yaml.safe_load(f) or {})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(hp.get("seed", 1234)))
        model = HifiGanGenerator(
            upsample_rates=tuple(config.get("upsample_rates", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(config.get("upsample_kernel_sizes",
                                                   (16, 16, 4, 4))),
            upsample_initial_channel=config.get("upsample_initial_channel", 512),
            resblock=str(config.get("resblock", "1")),
            resblock_kernel_sizes=tuple(config.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tuple(tuple(d) for d in config.get(
                "resblock_dilation_sizes", ((1, 3, 5),) * 3)),
            use_pitch_embed=config.get("use_pitch_embed", True),
            audio_sample_rate=config.get("audio_sample_rate", 22050),
            num_mels=config.get("audio_num_mel_bins", 80))
    ckpt = None
    if base_dir and os.path.exists(native := os.path.join(base_dir, "params.msgpack")):
        ckpt, sd = native, hifigan_from_jax(msgpack_ckpt.load(native))
    elif base_dir and (ckpt := newest_checkpoint(base_dir)) is not None:
        sd = load_state_dict(ckpt, "model_gen", lambda st: hifigan_from_jax(st["params"]))
    if ckpt is not None:
        load_into(model, sd, "HifiGAN")
        print(f"| Loaded HifiGAN weights from {ckpt}")
    model = model.to(device).eval()
    model.requires_grad_(False)
    return model, config, ckpt is not None


@register_vocoder
class HifiGAN(BaseVocoder):
    def __init__(self, hp: Optional[dict] = None, device=None):
        hp = hp if hp is not None else dict(global_hparams)
        self.hp = hp
        self.device = resolve_device(device or hp.get("device"))
        base_dir = hp.get("vocoder_ckpt", "")
        self.model, self.config, loaded = load_hifigan(base_dir, hp, self.device)
        cdt = hp.get("vocoder_compute_dtype") or hp.get("compute_dtype")
        self.dtype = torch.bfloat16 if cdt == "bfloat16" else torch.float32
        self.model.to(self.dtype)
        if not loaded:
            print(f"| WARNING: no HifiGAN checkpoint under '{base_dir}'; "
                  "using random init (smoke mode).")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(hp.get("seed", 1234)))

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, zero_noise: bool = False, **kwargs):
        """mel [T, 80]; f0 [T] Hz or None (arrays or tensors) -> wav
        [T * hop] float32 tensor on the vocoder's device."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        T = mel.shape[0]
        Tb = pick_bucket(T)
        mel_p = torch.nn.functional.pad(mel, (0, 0, 0, Tb - T))
        f0 = (torch.zeros(T, device=self.device) if f0 is None else
              torch.as_tensor(f0, dtype=torch.float32, device=self.device))
        f0_p = torch.nn.functional.pad(f0, (0, Tb - T))
        wav = self.model(mel_p[None].to(self.dtype), f0_p[None], generator=self.generator,
                         zero_noise=zero_noise)
        wav = wav[0, : T * self.model.hop].to(torch.float32)
        c = float(self.hp.get("vocoder_denoise_c", 0.0) or 0.0)
        if c > 0:
            wav = spectral_subtract(wav, self.hp["fft_size"], self.hp["hop_size"],
                                    self.hp["win_size"], c)
        return wav
