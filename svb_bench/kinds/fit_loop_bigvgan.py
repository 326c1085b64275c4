"""BigVGAN-v2 training through the program's own loop: the ``fit_loop``
kind (``next(loader)``, then ``Trainer._train_one``; set-up, the window,
the step past it and the comparison as there) with the task ``bigvgan``
registered into ``fit_loop.TASKS``: ``BigVGANTask`` with its generator, MPD
and MRD, against ``reference/bigvgan_step.py``.

Weights: the benchmark's seeded draw (``weights.py``), except that the
generator's convolution weights after ``conv_pre`` take BigVGAN's
N(0, 0.01) (its ``init_weights``, as ``BigVGANTask.build_model`` sets
them), on both sides: the fan-in scale would put most of the clamp's
inputs past +-1, a generator the recipe never trains.

Besides what ``fit_loop`` records, a ``--trace 1`` run records
``amp_least_s``: the AMP activations' least time over the traced steps
(``flops_bigvgan.amp_least_s`` at the configuration's crops, each crop
whole) for the ``amp_*`` readers."""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from .. import flops, flops_bigvgan, synth_bigvgan, weights
from ..harness import Result
from ..reference.bigvgan import BigVGAN as PlainGenerator
from . import fit_loop

CONV_STD = 0.01  # BigVGAN's init_weights


def _gen_kwargs(hp: dict) -> dict:
    return dict(num_mels=hp["audio_num_mel_bins"],
                upsample_rates=list(hp["upsample_rates"]),
                upsample_kernel_sizes=list(hp["upsample_kernel_sizes"]),
                upsample_initial_channel=hp["upsample_initial_channel"],
                resblock_kernel_sizes=list(hp["resblock_kernel_sizes"]),
                resblock_dilation_sizes=[list(d) for d in hp["resblock_dilation_sizes"]])


class BigVGAN:
    """BigVGAN-v2's task: generator, MPD and MRD, their crops."""
    names = ("gen", "mpd", "mrd")

    @staticmethod
    def task():
        from neuralsvb_torch.tasks.vocoder_task import BigVGANTask
        return BigVGANTask()

    @staticmethod
    def split(data_dir, traffic, seed):
        return synth_bigvgan.write_bigvgan_split(data_dir, traffic, seed)

    @staticmethod
    def modules(task):
        return {"gen": task.model, "mpd": task.mpd, "mrd": task.mrd}

    @staticmethod
    def kwargs(hp, task):
        return _gen_kwargs(hp)

    @staticmethod
    def reference(hp, kw, dev):
        from ..reference.bigvgan_step import BigVGANStep
        return BigVGANStep(hp, kw, dev)

    @staticmethod
    def shapes(batch) -> tuple:
        return tuple(np.shape(batch["wavs"]))

    @staticmethod
    def step_least_s(hp, kw, shapes, split, memo) -> float:
        """Every crop is whole (``max_samples``): no padding to leave out."""
        if shapes not in memo:
            memo[shapes] = flops.least_s(flops_bigvgan.step_flops(hp, kw, *shapes))
        return memo[shapes]

    cluster_least_s = None

    @staticmethod
    def rows_off(batches, split, hp) -> int:
        return fit_loop._crops_off(batches, split, hp["hop_size"])


fit_loop.TASKS["bigvgan"] = BigVGAN


def init_spec(module: nn.Module) -> weights.Spec:
    """``weights.init_spec``, with CONV_STD on the weights of a plain
    generator's convolutions other than ``conv_pre``."""
    spec = weights.init_spec(module)
    if not isinstance(module, PlainGenerator):
        return spec
    convs = {f"{n}.weight" for n, m in module.named_modules()
             if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)) and n != "conv_pre"}
    return [(name, shape, CONV_STD if name in convs else std, mean)
            for name, shape, std, mean in spec]


def run(ctx) -> Result:
    # the fit loop seeds the program's and the reference's modules from the
    # spec of the reference's modules
    fit_loop.init_spec = init_spec
    try:
        res = fit_loop.run(ctx)
    finally:
        fit_loop.init_spec = weights.init_spec
    if res.trace is not None:
        hp = ctx.config["hparams"]
        steps = sum(1 for name, _, _ in res.trace.spans if name == "train_one")
        res.record["amp_least_s"] = steps * flops_bigvgan.amp_least_s(
            _gen_kwargs(hp), int(hp["max_sentences"]), int(hp["max_samples"]))
    return res
