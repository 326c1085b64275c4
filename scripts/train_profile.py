#!/usr/bin/env python3
"""Where a training step of the PyTorch port's recipes goes, on one card.

For each ``--config`` (the flagship's ``vae_global_mle_eng_torch.yaml``
unless given; repeat it to compare recipes in one process), builds the
recipe's task at its full widths from seeded weights. An SVB recipe trains
on a synthetic packed train split of 4 pairs (amateur 1034-2412 frames, the
smoke run's Female1 lengths: one batch of 4, padded to 2560 frames); a
vocoder recipe (``PWGTask``, e.g. ``egs/egs_bases/tts/vocoder/pwg_torch.yaml``,
or ``HifiGanTask``) on ``max_sentences`` synthetic crops of ``max_samples``
(``neuralsvb_torch.data.synthetic.synthetic_crops``), its discriminator from step 0, and
reports its generator + discriminator step as phase 2; the ASR
pre-training recipe (``VCPPGTask``, ``egs/egs_bases/vc/vc_ppg_torch.yaml``)
on a synthetic speech split with phone tokens at its token budget (40
utterances of 750 frames: ``max_tokens`` 30000), its generator +
discriminator step as phase 2; the SVBPara family (``task_cls`` of
``tasks/svb_para.py`` on that recipe, through ``--variant``) on the SVB
recipes' paired split, cropped to the recipe's ``max_frames``, likewise;
a FastSpeech2 recipe (``FastSpeech2Task``, e.g.
``egs/egs_bases/tts/fs2_adv_torch.yaml``) on a synthetic speech split
with ``mel2ph`` at its budget (30 utterances of 1000 frames, 12 frames per
phone: 85 tokens each), likewise. Then:

- times warm phase-2 steps (generator + discriminator) and, for an SVB
  recipe, phase-3 steps (latent map), each between two
  ``torch.cuda.synchronize()`` calls;
- runs one warm phase-2 step under ``torch.profiler`` and sums the device
  time of its kernels and copies by name and by kind (user annotations such
  as ``Optimizer.step`` left out: they repeat their kernels), against the
  profiled step's wall time and the unprofiled median (the device's busy
  share), beside the same kernels' intervals merged per device
  (``neuralsvb_torch.utils.profiling``: ``top_ops``, ``kernel_split``,
  ``device_busy``; the two agree on one stream), and the program's spans
  of that step by name (``span_table``: count, total and self host ms of
  ``data.wait``, ``task.prep_batch``, ``update.*``, the models' spans).
  Every recipe but a vocoder's draws the profiled step's batch inside the
  profile from the task's own loader, which collates ahead on a thread
  (``ds_workers`` 1), so ``data.wait`` is that step's wait for its batch;
  a vocoder recipe trains on fixed synthetic crops and waits for none;
- reports peak device memory.

TF32 is off, as the training CLI sets it. Run from the repository root on
a machine with a CUDA card: ``python3 scripts/train_profile.py [--config
YAML ...] [--variant NAME:K=V,... ...] [--out FILE]``. Each ``--variant``
profiles every recipe again with those hparams on top (e.g. ``--variant
f32: --variant bf16:compute_dtype=bfloat16`` times the float32 and the bf16
step in one process, in that order). It prints one JSON object per recipe
and variant and writes their list to ``--out`` (default
``build/train_profile.json``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = (1034, 2412, 1241, 2171)
SPEECH_FRAMES = (750,) * 40
FS2_FRAMES = (1000,) * 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "build", "train_profile.json"))
    ap.add_argument("--warm", type=int, default=4, help="timed steps per phase")
    ap.add_argument("--config", action="append",
                    help="recipe yaml (repeatable; default the flagship's)")
    ap.add_argument("--variant", action="append",
                    help="NAME:HPARAMS, profiled per recipe (repeatable; default one, as is)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from neuralsvb_torch.data.synthetic import write_synthetic_split

    data = os.path.join(REPO, "build", "train_profile_data")
    for prefix, seed in (("train", 1), ("valid", 2)):
        write_synthetic_split(data, FRAMES, prefix=prefix, seed=seed)
    results = []
    variants = [v.partition(":")[::2] for v in args.variant or [":"]]
    for config in args.config or ["egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml"]:
        for name, extra in variants:
            res = dict(profile_recipe(config, data, args.warm, extra), variant=name,
                       hparams=extra)
            print(json.dumps(res), flush=True)
            results.append(res)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


def profile_recipe(config, data, warm, extra=""):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neuralsvb_torch.data.datasets import FastSpeechDataset
    from neuralsvb_torch.data.synthetic import synthetic_crops, write_synthetic_speech_split
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.adv_base import AdversarialTaskBase
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask
    from neuralsvb_torch.utils import profiling
    hp = set_hparams(config=config, hparams_str=extra, print_hparams=False,
                     global_hparams=False)
    pkg, cls_name = hp["task_cls"].rsplit(".", 1)
    task_cls = getattr(importlib.import_module(pkg), cls_name)
    vocoder = issubclass(task_cls, HifiGanTask)
    # the speech split is what FastSpeechDataset reads (VCPPGTask); the
    # SVBPara family reads the paired split of the SVB recipes
    speech = getattr(task_cls, "dataset_cls", None) is FastSpeechDataset
    paired = issubclass(task_cls, AdversarialTaskBase) and not speech
    from neuralsvb_torch.tasks.fs2 import FastSpeech2Task
    fs2 = issubclass(task_cls, FastSpeech2Task)
    frames = FS2_FRAMES if fs2 else SPEECH_FRAMES if speech else FRAMES
    if speech:
        data = os.path.join(REPO, "build", "train_profile_speech")
        write_synthetic_speech_split(data, frames, frames_per_phone=12 if fs2 else 8,
                                     mel2ph=fs2)
    hp = set_hparams(config=config,
                     hparams_str=f"binary_data_dir={data},pretrain_asr_ckpt=,"
                                 "ds_workers=1,endless_ds=True"
                                 + (f",{extra}" if extra else ""),
                     print_hparams=False, global_hparams=False)
    dev = torch.device("cuda")
    if hp.get("compute_dtype") == "bfloat16":
        torch.set_float32_matmul_precision("medium")  # as the training CLI sets it
    else:
        torch.set_float32_matmul_precision("highest")
    with hparams_scope(hp, **({"disc_start_steps": 0} if vocoder else {})) as h:
        task = task_cls()
        task.build_model()
        task.build_train()
        loader = None
        if vocoder:
            batch = synthetic_crops(int(h["max_sentences"]), h)
            step2 = 1
        else:
            # the task's own loader, collating ahead on its thread (one batch,
            # repeated: the split fits in one)
            loader = iter(task.train_dataloader())
            batch = next(loader)
            step2 = 1
            step3 = None if speech or paired else int(h["phase_2_steps"]) + 1

        def run(step):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for idx in range(task.num_optimizers):
                task.training_step(batch, step, idx)
            torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats(dev)
        first2 = run(step2 if vocoder else 0)  # the SVB disc starts after step 0
        times2 = [run(step2) for _ in range(warm + 1)]
        first3 = times3 = None
        if not (vocoder or speech or paired):
            first3 = run(step3)
            times3 = [run(step3) for _ in range(warm)]
        peak = torch.cuda.max_memory_allocated(dev)

        torch.cuda.synchronize(dev)
        profiling.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if loader is not None:
                batch = next(loader)  # the step's wait for its batch: span data.wait
            wall = run(step2)
        spans = profiling.span_table()
        kinds, launches = profiling.kernel_split(prof)
        busy = sum(v[0] for v in kinds.values())
        merged = {k: v * 1e3 for k, v in profiling.device_busy(prof).items()}
        rows = profiling.top_ops(prof, k=25)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    return {
        "config": config, "task_cls": hp["task_cls"],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "batch": [int(batch["nsamples"]), int(batch["mels"].shape[1])],
        "samples": int(batch["wavs"].shape[1]) if vocoder else None,
        "frames": None if vocoder else list(frames),
        "tf32": False,
        "phase2_first_step_s": first2, "phase2_warm_steps_s": times2[1:],
        "phase2_median_s": statistics.median(times2[1:]),
        "phase3_first_step_s": first3, "phase3_warm_steps_s": times3,
        "phase3_median_s": statistics.median(times3) if times3 else None,
        "max_memory_allocated": peak,
        "profiled_phase2_step": {
            "wall_ms": wall * 1e3, "kernel_ms": busy, "busy_share": busy / (wall * 1e3),
            "busy_share_of_unprofiled_median": busy / (statistics.median(times2[1:]) * 1e3),
            "merged_busy_ms": merged,
            "merged_busy_share": sum(merged.values()) / (wall * 1e3),
            "merged_busy_share_of_unprofiled_median":
                sum(merged.values()) / (statistics.median(times2[1:]) * 1e3),
            "launches": launches,
            "by_kind_ms": {k: {"ms": v[0], "launches": v[1], "share": v[0] / busy}
                           for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][0])},
            "top_kernels": [{"name": n[:120], "ms": sec * 1e3, "launches": c}
                            for n, sec, c in rows]},
        "spans": spans,
    }


if __name__ == "__main__":
    main()
