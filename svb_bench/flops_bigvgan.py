"""Work of a ``bigvgan_v2_24k`` training step, counted from shapes on the
frozen reference (``reference/bigvgan.py``), never on the program's
modules, with the peaks of ``flops.py``.

- ``step_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  generator's update and the discriminators' update on meta tensors,
  forward and backward (convolutions at 2 x their multiply-adds, the AMP
  resamplings' depthwise convolutions among them; nothing for elementwise
  work or FFTs); all float32, TF32 off.
- ``amp_least_s``: the AMP activations' least time in one step, forward
  and backward: per activation the larger of its operations at the
  float32 peak and its bytes at the HBM peak, each tensor read once and
  written once (forward: x read, y written; backward: x and dy read, dx
  written; the per-channel parameters and their gradients are left out).
  Per output element the forward's operations are the upsampling's 2 x (6
  multiply-adds and a scale), SnakeBeta's 2 x 5 operations and the
  downsampling's 12 multiply-adds (60); the backward recomputes the
  upsampling and adds the strided conv's transpose, SnakeBeta's
  derivatives and the upsampling's transpose (110)."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .flops import PEAK_F32, PEAK_HBM, meta

AMP_FWD_FLOP, AMP_BWD_FLOP = 60, 110
AMP_FWD_BYTES, AMP_BWD_BYTES = 8, 12


def amp_shapes(gen_kwargs: dict, batch: int, samples: int) -> List[Tuple[int, int, int, int]]:
    """(activations, B, C, T) per shape the step's AMP activations run at:
    2 per tower step per stage (towers x dilations x 2), then the final one
    at the last stage's shape."""
    rates = gen_kwargs["upsample_rates"]
    t = samples // math.prod(rates)
    per_stage = 2 * sum(len(d) for d in gen_kwargs["resblock_dilation_sizes"])
    out = []
    for i, u in enumerate(rates):
        t *= u
        out.append((per_stage, batch, gen_kwargs["upsample_initial_channel"] // 2 ** (i + 1), t))
    n, B, C, T = out[-1]
    out.append((1, B, C, T))
    return out


def amp_elements(gen_kwargs: dict, batch: int, samples: int) -> int:
    """Output elements of the step's AMP activations (one pass)."""
    return sum(n * B * C * T for n, B, C, T in amp_shapes(gen_kwargs, batch, samples))


def amp_least_s(gen_kwargs: dict, batch: int, samples: int) -> float:
    total = 0.0
    for n, B, C, T in amp_shapes(gen_kwargs, batch, samples):
        e = B * C * T
        total += n * (max(AMP_FWD_FLOP * e / PEAK_F32, AMP_FWD_BYTES * e / PEAK_HBM)
                      + max(AMP_BWD_FLOP * e / PEAK_F32, AMP_BWD_BYTES * e / PEAK_HBM))
    return total


def _key(d: dict):
    return tuple(sorted((k, tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                         else tuple(v) if isinstance(v, (list, tuple)) else v)
                        for k, v in d.items()))


@lru_cache(maxsize=4)
def _step_flops(gen_key, mpd_periods: Sequence[int], resolutions, batch: int,
                samples: int) -> int:
    from .reference.bigvgan import BigVGAN, MultiPeriodDiscriminator, MultiResolutionDiscriminator
    kw = dict(gen_key)
    with torch.device("meta"):
        g = BigVGAN(**kw)
        mpd = MultiPeriodDiscriminator(mpd_periods)
        mrd = MultiResolutionDiscriminator(resolutions)
    hop = math.prod(kw["upsample_rates"])
    mel, wav = meta((batch, samples // hop, kw["num_mels"])), meta((batch, samples))
    discs = (mpd, mrd)
    disc_params = list(mpd.parameters()) + list(mrd.parameters())
    with FlopCounterMode(display=False) as fc:
        for p in disc_params:
            p.requires_grad_(False)
        y = g(mel)
        loss = y.abs().mean()
        for d in discs:
            out, fmap = d(y)
            with torch.no_grad():
                real = d(wav)[1]
            loss = loss + sum(o.mean() for o in out) + sum(
                (a - b).abs().mean() for fr, fg in zip(real, fmap) for a, b in zip(fr, fg))
        loss.backward()
        for p in disc_params:
            p.requires_grad_(True)
        y = y.detach()
        loss = 0
        for d in discs:
            loss = loss + sum(o.mean() for o in d(wav)[0] + d(y)[0])
        loss.backward()
    return int(fc.get_total_flops())


def step_flops(hp: dict, gen_kwargs: dict, batch: int, samples: int) -> Dict[str, int]:
    """FLOPs of one training step (the generator's update with feature
    matching, then both discriminators'), forward and backward, all
    float32 (``{"bf16": 0, "f32": ...}``, the form ``flops.least_s``
    takes). The mel loss's STFT and the MRD's are not counted."""
    res = tuple(tuple(r) for r in hp["resolutions"])
    return {"bf16": 0, "f32": _step_flops(_key(gen_kwargs), tuple(hp["mpd_reshapes"]), res,
                                          batch, samples)}
