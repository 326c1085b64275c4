"""Parallel WaveGAN inference wrapper, the ``pwg`` entry of the vocoder
registry (``egs/egs_bases/tts/base.yaml``: ``vocoder: pwg``); port of
``neuralsvb_tpu/vocoders/pwg.py`` (reference: vocoders/pwg.py:17-137).

``spec2wav`` edge-pads the mel by ``aux_context_window`` on the left and up
to its ``pick_bucket`` plus the context on the right, draws ``z ~ N(0, 1)``
of ``bucket * hop`` samples from the vocoder's own ``torch.Generator`` (or
takes an injected ``z``), runs the generator on the vocoder's device and
returns ``T * hop`` samples. ``wav2spec`` is ``BaseVocoder``'s.

The generator is built from the keys ``load_pwg`` of the JAX package reads,
which are not those of its ``PWGTask``: ``generator_params.upsample_params.
upsample_scales`` (default 4,4,4,4) and ``generator_params.aux_context_window``
(default 2). A config that sets both key sets alike serves its own training
run; one that does not raises on the mismatched shapes.

Loading order, as in the JAX package, plus the port's own checkpoints:
1. ``<vocoder_ckpt>/params.msgpack`` (flax params) through
   ``convert/msgpack_ckpt.py`` and ``pwg_from_jax``;
2. a PyTorch checkpoint: the newest ``model_ckpt_steps_*.ckpt`` (the
   port's ``PWGTask`` writes them; a JAX package checkpoint of that name is
   read through its ``state.params``), else the last of the sorted
   ``*.ckpt`` then ``*.pkl`` files. ``state_dict.model_gen``, or the
   official ``{"model": {"generator": ...}}``, weight norm folded. An
   official checkpoint's features are scaled by ``stats.npy`` (or
   ``stats.h5`` when ``format`` is ``hdf5``, which needs ``h5py``);
3. otherwise seeded random init with the JAX warning.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from ..convert import msgpack_ckpt
from ..convert.checkpoint import (is_torch_file, fold_weight_norm, load_into,
                                  load_state_dict, newest_checkpoint)
from ..convert.jax2torch import pwg_from_jax
from ..hparams import hparams as global_hparams
from ..hparams import resolve_device
from ..models.pwg import ParallelWaveGANGenerator
from ..ops.audio import load_wav
from ..ops.mel_filters import mel_filterbank
from ..ops.pitch_utils import f0_to_coarse
from ..ops.stft import hann_window
from .base import BaseVocoder, register_vocoder
from .hifigan import pick_bucket


def _config(base_dir: str, hp: dict) -> dict:
    config = dict(hp)
    for name in ("config.yaml", "config.yml"):
        path = os.path.join(base_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                config.update(yaml.safe_load(f) or {})
            break
    return config


def _torch_checkpoint(base_dir: str) -> Optional[str]:
    newest = newest_checkpoint(base_dir)
    if newest is not None:
        return newest
    ckpts = (sorted(glob.glob(os.path.join(base_dir, "*.ckpt")))
             + sorted(glob.glob(os.path.join(base_dir, "*.pkl"))))
    return ckpts[-1] if ckpts else None


def _read_torch(path: str):
    """(generator state_dict, official?) of a reference-format file."""
    if not is_torch_file(path):
        return load_state_dict(path, "model_gen", lambda st: pwg_from_jax(st["params"])), False
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refuses this pickle (official "
            "ParallelWaveGAN checkpoints hold more than tensors). If the file is "
            "trusted, re-save its generator: torch.save({'model': {'generator': "
            "torch.load(path, weights_only=False)['model']['generator']}}, "
            "'generator.pkl')") from e
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return load_state_dict(path, "model_gen"), False
    try:
        sd = ckpt["model"]["generator"]
    except (KeyError, TypeError):
        raise KeyError(f"{path}: neither state_dict.model_gen nor model.generator") from None
    return fold_weight_norm(dict(sd)), True


def _official_stats(base_dir: str, fmt: str):
    """(mean, scale) of an official checkpoint's feature scaler, or None
    (reference: vocoders/pwg.py:28-38)."""
    h5 = os.path.join(base_dir, "stats.h5")
    npy = os.path.join(base_dir, "stats.npy")
    if fmt == "hdf5" and os.path.exists(h5):
        try:
            import h5py
        except ImportError as e:
            raise RuntimeError(f"{h5} needs h5py, which is not installed; write its "
                               "mean and scale rows to stats.npy instead") from e
        with h5py.File(h5, "r") as f:
            return np.asarray(f["mean"], np.float32), np.asarray(f["scale"], np.float32)
    if os.path.exists(npy):
        stats = np.load(npy)
        if stats.ndim != 2 or stats.shape[0] != 2:
            raise ValueError(f"{npy}: expected [2, num_mels] (mean, scale), got {stats.shape}")
        return np.asarray(stats[0], np.float32), np.asarray(stats[1], np.float32)
    return None


def load_pwg(base_dir: str, hp: dict, device: torch.device):
    """Returns (generator in eval mode on ``device``, config dict, feature
    scaler or None, the file loaded or None)."""
    config = _config(base_dir, hp) if base_dir else dict(hp)
    gp = config.get("generator_params") or {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(hp.get("seed", 1234)))
        model = ParallelWaveGANGenerator(
            layers=gp.get("layers", 30), stacks=gp.get("stacks", 3),
            residual_channels=gp.get("residual_channels", 64),
            gate_channels=gp.get("gate_channels", 128),
            skip_channels=gp.get("skip_channels", 64),
            aux_channels=gp.get("aux_channels", 80),
            aux_context_window=gp.get("aux_context_window", 2),
            upsample_scales=tuple((gp.get("upsample_params") or {})
                                  .get("upsample_scales", (4, 4, 4, 4))),
            use_pitch_embed=gp.get("use_pitch_embed", False))
    scaler, path = None, None
    if base_dir and os.path.exists(native := os.path.join(base_dir, "params.msgpack")):
        path = native
        load_into(model, pwg_from_jax(msgpack_ckpt.load(native)), "PWG")
    elif base_dir and (path := _torch_checkpoint(base_dir)) is not None:
        sd, official = _read_torch(path)
        load_into(model, sd, "PWG")
        if official:
            scaler = _official_stats(base_dir, config.get("format", "hdf5"))
    model = model.to(device).eval().requires_grad_(False)
    return model, config, scaler, path


@register_vocoder
class PWG(BaseVocoder):
    def __init__(self, hp: Optional[dict] = None, device=None):
        hp = hp if hp is not None else dict(global_hparams)
        self.hp = hp
        self.device = resolve_device(device or hp.get("device"))
        base_dir = hp.get("vocoder_ckpt", "")
        self.model, self.config, self.scaler, path = load_pwg(base_dir, hp, self.device)
        if path is None:
            print(f"| WARNING: no PWG checkpoint under '{base_dir}'; random init.")
        else:
            print(f"| Loaded PWG weights from {path}")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(hp.get("seed", 1234)))

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, z: Optional[torch.Tensor] = None,
                 zero_noise: bool = False, **kwargs):
        """mel [T, aux]; f0 [T] Hz (read with ``use_pitch_embed``); z [1, 1,
        bucket * hop] or None (drawn; zeros with ``zero_noise``) -> wav
        [T * hop] float32 tensor on the vocoder's device."""
        m = self.model
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if self.scaler is not None:  # an official checkpoint's feature scaling
            mean, scale = (torch.as_tensor(a, device=self.device) for a in self.scaler)
            mel = (mel - mean) / scale
        T = mel.shape[0]
        Tb = pick_bucket(T)
        ctx = m.aux_context_window
        c = F.pad(mel.T[None], (ctx, Tb - T + ctx), mode="replicate")
        shape = (1, 1, Tb * m.hop)
        if z is None:
            z = (torch.zeros(shape, device=self.device) if zero_noise else
                 torch.randn(shape, generator=self.generator, device=self.device))
        pitch = None
        if m.use_pitch_embed and f0 is not None:
            f0 = f0.cpu().numpy() if torch.is_tensor(f0) else np.asarray(f0)
            pitch = torch.as_tensor(np.pad(f0_to_coarse(f0), (0, Tb - T)),
                                    device=self.device)[None]
        wav = m(torch.as_tensor(z, dtype=torch.float32, device=self.device), c, pitch)
        return wav[0, : T * m.hop]

    @staticmethod
    def wav2mfcc(wav_fn):
        """13 MFCCs and their first and second deltas, [T, 39], from a 128-band
        dB mel of the magnitude STFT (reference: vocoders/pwg.py:124-137),
        computed in float64 on the ``device`` the hparams name."""
        from scipy.fftpack import dct
        hp = global_hparams
        wav, _ = load_wav(wav_fn, sr=hp["audio_sample_rate"])
        device = resolve_device(hp.get("device"))
        fft, hop, win = hp["fft_size"], hp["hop_size"], hp["win_size"]
        spec = torch.stft(torch.as_tensor(np.asarray(wav, np.float64), device=device),
                          n_fft=fft, hop_length=hop, win_length=win,
                          window=torch.as_tensor(hann_window(win), device=device),
                          center=True, pad_mode="constant", return_complex=True).abs()
        basis = torch.as_tensor(mel_filterbank(hp["audio_sample_rate"], fft, 128, 0,
                                               hp["audio_sample_rate"] / 2, dtype=np.float64),
                                device=device)
        mel_db = 10 * torch.log10(torch.clamp(basis @ spec, min=1e-10))
        mfcc = dct(mel_db.cpu().numpy(), axis=0, type=2, norm="ortho")[:13]
        d1 = np.gradient(mfcc, axis=1)
        d2 = np.gradient(d1, axis=1)
        return np.concatenate([mfcc, d1, d2]).T
