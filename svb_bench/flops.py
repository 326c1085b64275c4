"""Work of the cells' calls, counted from shapes on the frozen reference,
never on the program's modules (a later kernel that replaces a
convolution does not change the work it is credited with); and the
published peaks of one NVIDIA H100 SXM (dense, 700 W).

- ``cluster_flops`` / ``cluster_bytes``: the HiFiGAN ResBlock cluster, by
  formula (the roofline of its kernels).
- ``count``: ``torch.utils.flop_counter.FlopCounterMode`` over a call on
  the meta device: matmuls and convolutions at 2 x their multiply-adds
  (a transposed convolution: 2 x C_in x C_out x k x T_in), nothing for
  elementwise work, norms or FFTs.
- ``request_least_s`` and ``train_step_least_s``: the least time of a
  request or a training step, each group of operations at the peak of the
  precision the configuration runs it in (the cluster's forward operands
  bf16, everything else float32 with TF32 off)."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16 = 989e12   # FLOP/s, dense bf16 on the tensor cores
PEAK_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12   # bytes/s


def stage_shapes(t_mel: int, upsample_rates: Sequence[int],
                 initial_channel: int) -> Tuple[Tuple[int, int], ...]:
    """(channels, samples) of each upsample stage's cluster for ``t_mel``
    frames."""
    out, t = [], t_mel
    for i, u in enumerate(upsample_rates):
        t *= u
        out.append((initial_channel // 2 ** (i + 1), t))
    return tuple(out)


def cluster_flops(batch: int, stages, kernel_sizes: Sequence[int],
                  dilations: Sequence[Sequence[int]]) -> int:
    """2 x the multiply-adds of the cluster's convolutions: per tower of
    kernel k, two k-tap C x C convolutions per dilation."""
    taps = sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    return sum(2 * batch * c * c * t * taps for c, t in stages)


def cluster_bytes(batch: int, stages, kernel_sizes: Sequence[int],
                  dilations: Sequence[Sequence[int]]) -> int:
    """Each input read once and each output written once: the stage input
    and the tower mean in float32, the bf16 weights and float32 biases."""
    taps = sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilations))
    convs = sum(2 * len(d) for d in dilations)
    return sum(2 * 4 * batch * c * t + 2 * c * c * taps + 4 * c * convs for c, t in stages)


def count(fn, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` (run it on meta tensors)."""
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return int(fc.get_total_flops())


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@lru_cache(maxsize=4)
def _svb(svb_key):
    from .reference.svb_vae import SVBVAE
    with torch.device("meta"):
        return SVBVAE(**dict(svb_key)).eval()


@lru_cache(maxsize=4)
def _generator(gen_key):
    from .reference.hifigan import HifiGanGenerator
    with torch.device("meta"):
        g = HifiGanGenerator(**dict(gen_key))
    g.operand = None
    return g


def _key(d: dict):
    return tuple(sorted((k, tuple(map(tuple, v)) if k == "resblock_dilation_sizes"
                         else tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def svb_forward_flops(svb_kwargs: dict, t_a: int, t_p: int) -> int:
    """The SVB model's a2a, p2p and a2p forward for one request of ``t_a``
    amateur and ``t_p`` professional frames."""
    m = _svb(_key(svb_kwargs))
    n_mels = svb_kwargs.get("num_mel_bins", 80)
    with torch.no_grad():
        return count(m, meta((1, t_a, n_mels)), meta((1, t_p, n_mels)),
                     meta((1, t_a), torch.long), meta((1, t_p), torch.long),
                     meta((1, 256)), meta((1, t_p), torch.long), zero_noise=True)


@lru_cache(maxsize=4)
def _generator_rest_per_frame(gen_key) -> int:
    """FLOPs per mel frame of one sequence through every generator layer
    but the cluster; all of them are linear in the frames (the tests hold
    this at two lengths)."""
    g, kw = _generator(gen_key), dict(gen_key)
    t = 64
    with torch.no_grad():
        total = count(g, meta((1, t, kw.get("num_mels", 80))), meta((1, t)), zero_noise=True)
    clu = cluster_flops(1, stage_shapes(t, kw["upsample_rates"], kw["upsample_initial_channel"]),
                        kw["resblock_kernel_sizes"], kw["resblock_dilation_sizes"])
    return (total - clu) // t


def generator_flops(gen_kwargs: dict, batch: int, t_mel: int) -> Tuple[int, int]:
    """(cluster FLOPs, all other FLOPs) of the generator's forward on
    ``batch`` x ``t_mel`` frames."""
    clu = cluster_flops(batch, stage_shapes(t_mel, gen_kwargs["upsample_rates"],
                                            gen_kwargs["upsample_initial_channel"]),
                        gen_kwargs["resblock_kernel_sizes"],
                        gen_kwargs["resblock_dilation_sizes"])
    return clu, _generator_rest_per_frame(_key(gen_kwargs)) * batch * t_mel


def request_least_s(svb_kwargs: dict, gen_kwargs: dict, t_a: int, t_p: int) -> float:
    """Least time of one a2p request at its own frames (not its bucket)."""
    clu, rest = generator_flops(gen_kwargs, 1, t_p)
    return (svb_forward_flops(svb_kwargs, t_a, t_p) + rest) / PEAK_F32 + clu / PEAK_BF16


def hifigan_step_flops(gen_kwargs: dict, batch: int, samples: int) -> Dict[str, int]:
    """FLOPs of one HiFiGAN training step (a generator update, then a
    discriminator update), forward and backward: {"bf16": the cluster's
    forward, "f32": the rest}. The mel loss's STFT is not counted."""
    from .reference.hifigan import MultiPeriodDiscriminator, MultiScaleDiscriminator
    hop = math.prod(gen_kwargs["upsample_rates"])
    g = _generator(_key(gen_kwargs))
    with torch.device("meta"):
        mpd, msd = MultiPeriodDiscriminator(), MultiScaleDiscriminator()
    t_mel = samples // hop
    mel, f0, wav = meta((batch, t_mel, gen_kwargs.get("num_mels", 80))), \
        meta((batch, t_mel)), meta((batch, samples))
    disc_params = list(mpd.parameters()) + list(msd.parameters())

    def gen_update():
        for p in disc_params:
            p.requires_grad_(False)
        y = g(mel, f0, zero_noise=True)
        loss = y.abs().mean() + sum(o.mean() for o in mpd(y)[0] + msd(y)[0])
        loss.backward()
        for p in disc_params:
            p.requires_grad_(True)
        return y.detach()

    def disc_update(y):
        loss = sum(o.mean() for o in mpd(wav)[0] + msd(wav)[0] + mpd(y)[0] + msd(y)[0])
        loss.backward()

    with FlopCounterMode(display=False) as fc:
        y = gen_update()
        disc_update(y)
    clu = cluster_flops(batch, stage_shapes(t_mel, gen_kwargs["upsample_rates"],
                                            gen_kwargs["upsample_initial_channel"]),
                        gen_kwargs["resblock_kernel_sizes"],
                        gen_kwargs["resblock_dilation_sizes"])
    return {"bf16": clu, "f32": int(fc.get_total_flops()) - clu}


def least_s(flops: Dict[str, int]) -> float:
    return flops["bf16"] / PEAK_BF16 + flops["f32"] / PEAK_F32


def svb_step_flops(hp: dict, svb_kwargs: dict, mel_shape, prof_shape) -> Dict[str, int]:
    """FLOPs of one phase-2 step of the flagship on a batch of amateur mels
    ``mel_shape`` [B, T_a, 80] and professional ``prof_shape``: the
    generator's update (the ways of phase 2 from cached content rows, the
    mel losses, the frozen discriminator's windows, backward) and the
    discriminator's (real and generated windows, backward); all float32.
    The windows start at frame 0 (their work does not depend on where)."""
    from .reference.svb_step import MEL_LOSSES, SVBStep
    with torch.device("meta"):
        ref = SVBStep(dict(hp, seed=0), svb_kwargs, "meta")
    model, disc = ref.model, ref.disc
    B, t_a, n_mels = mel_shape
    t_p = prof_shape[1]
    stride = math.prod(hp["mel_strides"])
    ways = tuple(hp["phase_2_concurrent_ways"].split(","))
    mels, prof = meta(mel_shape), meta(prof_shape)
    wins = [0] * hp["disc_win_num"]
    model.train()
    disc.eval()  # dropout does no counted work; it needs a generator in training
    with FlopCounterMode(display=False) as fc:
        out = model(mels, prof, meta((B, t_a), torch.long), meta((B, t_p), torch.long),
                    meta((B, 256)), meta((B, t_p), torch.long), zero_noise=True, ways=ways,
                    ppg_a=meta((B, hp["hidden_size"], -(-t_a // stride))),
                    ppg_p=meta((B, hp["hidden_size"], -(-t_p // stride))))
        loss = 0
        for way in ways:
            target = prof if way in ("p2p", "a2p") else mels
            for name in ref.losses:
                loss = loss + MEL_LOSSES[name](out[way]["mel_out"], target)
            for p in ref.disc_params:
                p.requires_grad_(False)
            loss = loss + disc(out[way]["mel_out"], wins)["y"].mean()
            for p in ref.disc_params:
                p.requires_grad_(True)
        loss.backward()
        d = 0
        for way in ways:
            target = prof if way in ("p2p", "a2p") else mels
            d = d + disc(target, wins)["y"].mean() + disc(out[way]["mel_out"].detach(),
                                                          wins)["y"].mean()
        d.backward()
    return {"bf16": 0, "f32": int(fc.get_total_flops())}
