#!/usr/bin/env python3
"""How far the vocoder generator's float32 gradient moves under tiny input
changes: the conditioning that bounds any comparison of two float32 runs
(card vs CPU, PyTorch vs JAX) of ``HifiGanTask``'s generator step.

Builds the recipe's ``HifiGanTask`` (``hifigan_nsf_torch.yaml``, seeded
weights; ``--channels`` shrinks the generator) on the CPU, takes one
generator step's gradient (before clipping, zero NSF noise) on ``--batch``
synthetic sung crops whose f0 lies on a grid of sr/1024 Hz (NSF phase sums
exact), then again after one change at a time:

- ``mel``: the input mel scaled by 1 + 1e-7 N(0, 1) (about one ulp);
- ``weights``: every generator weight scaled the same way;
- ``phase``: the overtones' initial NSF phase moved by ``--phase`` cycles
  (about the rounding of another float32 cumsum order over the crop).

Per change it prints the worst tensors' max|d| over their scale (max(max|g|,
1e-3 of the largest)), their relative L2 error, and the whole gradient's
relative L2 error. Run from the repository root: ``python3
scripts/vocoder_grad_conditioning.py [--channels 512 --batch 2]`` (CPU,
about 10 s per step at full width on 8 cores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=512, help="upsample_initial_channel")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--phase", type=float, default=3e-5)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import numpy as np
    import torch
    from neuralsvb_torch.data.synthetic import synthetic_crops
    from neuralsvb_torch.hparams import hparams_scope, load_config_recursive
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask

    hp = load_config_recursive("egs/datasets/audio/PopBuTFy/hifigan_nsf_torch.yaml")
    hp.update(device="cpu", upsample_initial_channel=args.channels, zero_noise=True)
    with hparams_scope(hp) as h:
        batch = synthetic_crops(args.batch, h)
        step = h["audio_sample_rate"] / 1024
        batch["f0"] = (np.round(batch["f0"] / step) * step).astype(np.float32)

        def grads(change=None):
            task = HifiGanTask()
            task.build_model()
            task.build_train()
            b = dict(batch)
            noise = np.random.RandomState(2)
            if change == "mel":
                b["mels"] = (b["mels"] * (1 + 1e-7 * noise.randn(*b["mels"].shape))
                             ).astype(np.float32)
            if change == "weights":
                with torch.no_grad():
                    for p in task.model.parameters():
                        p.mul_(1 + 1e-7 * torch.as_tensor(noise.randn(*p.shape),
                                                          dtype=p.dtype))
            if change == "phase":
                dim = task.model.m_source.l_sin_gen.harmonic_num + 1
                L = b["wavs"].shape[1]
                ini = torch.full((args.batch, dim), args.phase)
                forward = task.model.forward
                task.model.forward = lambda mel, f0, **kw: forward(
                    mel, f0, zero_noise=True, rand_ini=ini,
                    noise=torch.zeros(args.batch, dim, L))
            out = {}
            task.grad_hook = lambda group, params: out.__setitem__(
                group, [p.grad.detach().double().clone() for p in params])
            task.training_step(b, 1, 0)
            return out["gen"], [n for n, _ in task.model.named_parameters()]

        ref, names = grads()
        big = max(float(t.abs().max()) for t in ref)
        scales = [max(float(t.abs().max()), 1e-3 * big) for t in ref]
        res = {"channels": args.channels, "batch": args.batch, "phase_cycles": args.phase}
        for change in ("mel", "weights", "phase"):
            g, _ = grads(change)
            rows = sorted(((float((a - r).abs().max()) / s,
                            float((a - r).norm() / r.norm().clamp_min(1e-30)), n)
                           for a, r, s, n in zip(g, ref, scales, names)), reverse=True)
            l2 = float(torch.sqrt(sum(((a - r) ** 2).sum() for a, r in zip(g, ref)))
                       / torch.sqrt(sum((r ** 2).sum() for r in ref)))
            res[change] = {"max_over_scale": rows[0][0], "worst_tensors": rows[:3],
                           "worst_tensor_l2": max(r[1] for r in rows), "group_l2": l2}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
