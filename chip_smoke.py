#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``neuralsvb_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a CUDA
card and the CUDA toolkit (nvcc); without them it raises and exits non-zero.
Every phase prints one JSON line; any failure raises.

1. environment: torch / CUDA versions, the card, its power limit;
2. build: nvcc builds ``neuralsvb_torch/csrc/fused_resblock.cu`` for sm_90a;
3. kernel vs plain: the ResBlock-cluster kernel against its plain PyTorch
   version (``F.conv1d``, TF32 off) at the flagship vocoder's stage shapes
   for 1024 mel frames, a ragged length and B=2, max|d| <= 1e-4 * max(1,
   max|ref|); median times over 20 runs from CUDA events; the autograd path's
   gradients;
4. main path: ``python -m neuralsvb_torch.tasks.run --infer`` on a synthetic
   4-utterance packed test split (6-10 s each) at the flagship widths
   (SVBVAE hidden 256 / latent 128 / FVAE 192 k5 8+4, 2-layer conformer
   ASR; HiFiGAN-NSF 512 channels, rates 8,8,2) with seeded random weights;
   it must write 4 x 5 wavs of length frames x 128 that are finite and not
   silent, and launch the kernel 18 x 3 stages x 20 vocoder calls times;
5. card vs CPU: one utterance at zero noise through the port's slice on the
   card (kernel) and on the CPU (plain versions, which the CPU tests hold to
   the JAX package): mel_out and wav within 1e-3, TF32 off.

The line before the last is the kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""

import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import wave

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
UTT_FRAMES = (1040, 1300, 1560, 1780)  # 6.0 - 10.3 s at hop 128, 22050 Hz
STAGE_SHAPES = ((1, 256, 8192), (1, 128, 65536), (1, 64, 131072))  # T_mel 1024
EXTRA_SHAPES = ((1, 256, 8000), (2, 128, 16384))  # ragged T, B = 2
TPU_KERNEL = "neuralsvb_tpu/ops/fused_resblock.py:82"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def tf32(on):
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def median_ms(fn, n=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def random_cluster(C, spec, gen, device):
    """Packed cluster weights at default-conv scale, from ``gen``."""
    import torch
    ws = []
    for k, dils in spec:
        n, s = len(dils), (C * k) ** -0.5
        ws += [torch.randn(n, C, k, C, generator=gen) * s,
               torch.randn(n, C, generator=gen) * s,
               torch.randn(n, C, k, C, generator=gen) * s,
               torch.randn(n, C, generator=gen) * s]
    return [w.to(device) for w in ws]


def phase_kernel(fr, spec):
    import torch
    gen = torch.Generator().manual_seed(0)
    rows, worst = [], 0.0
    for B, C, T in STAGE_SHAPES + EXTRA_SHAPES:
        x = torch.randn(B, C, T, generator=gen).cuda()
        w = random_cluster(C, spec, gen, "cuda")
        with torch.no_grad():
            tf32(False)
            ref = fr.resblock_cluster_plain(x, w, spec)
            out = fr.fused_resblock_cluster(x, w, spec)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            ok = err <= 1e-4 * scale and bool(torch.isfinite(out).all())
            kernel_ms = median_ms(lambda: fr.fused_resblock_cluster(x, w, spec))
            plain_ms = median_ms(lambda: fr.resblock_cluster_plain(x, w, spec))
            tf32(True)
            plain_tf32_ms = median_ms(lambda: fr.resblock_cluster_plain(x, w, spec))
            tf32(False)
        gflop = 2 * B * T * C * C * sum(2 * k * len(d) for k, d in spec) / 1e9
        row = dict(B=B, C=C, T=T, max_abs_err=err, tol=1e-4 * scale, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   plain_tf32_ms=plain_tf32_ms,
                   kernel_tflops=gflop / kernel_ms)
        emit("kernel_vs_plain", **row)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {row}")
        rows.append(row)
        worst = max(worst, err)
        del x, w, ref, out
    # gradients through the autograd path (kernel forward, plain backward)
    x = torch.randn(1, 64, 700, generator=gen).cuda().requires_grad_(True)
    w = [t.requires_grad_(True) for t in random_cluster(64, spec, gen, "cuda")]
    g = torch.randn(1, 64, 700, generator=gen).cuda()
    (fr.fused_resblock_cluster(x, w, spec) * g).sum().backward()
    got = [x.grad] + [t.grad for t in w]
    x2 = x.detach().clone().requires_grad_(True)
    w2 = [t.detach().clone().requires_grad_(True) for t in w]
    (fr.resblock_cluster_plain(x2, w2, spec) * g).sum().backward()
    want = [x2.grad] + [t.grad for t in w2]
    gerr = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
               for a, b in zip(got, want))
    emit("autograd", shape=[1, 64, 700], max_rel_grad_err=gerr, ok=gerr <= 1e-4)
    if gerr > 1e-4:
        raise AssertionError(f"autograd gradients disagree: {gerr}")
    return rows, worst


def vocoder_keys():
    """The HiFiGAN-NSF generator of the PopBuTFy vocoder recipe."""
    from neuralsvb_torch.hparams import load_config_recursive
    cfg = load_config_recursive("egs/datasets/audio/PopBuTFy/hifigan_nsf.yaml")
    keys = ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
            "resblock", "resblock_kernel_sizes", "resblock_dilation_sizes",
            "use_pitch_embed", "audio_sample_rate", "audio_num_mel_bins")
    return {k: cfg[k] for k in keys}


def phase_main_path(voc):
    import numpy as np
    import yaml
    from neuralsvb_torch.data.synthetic import write_synthetic_split
    data, voc_dir, work = (os.path.join(WORK, d) for d in ("data", "voc", "work"))
    write_synthetic_split(data, UTT_FRAMES, seed=1234)
    os.makedirs(voc_dir)
    with open(os.path.join(voc_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(voc, f)
    cfg = os.path.join(WORK, "infer.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({
            "base_config": [os.path.join(
                REPO, "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml")],
            "binary_data_dir": data, "vocoder_ckpt": voc_dir, "device": "cuda",
            "hidden_size": 256, "latent_size": 128, "fvae_enc_dec_hidden": 192,
            "fvae_kernel_size": 5, "fvae_enc_n_layers": 8, "fvae_dec_n_layers": 4,
            "asr_enc_layers": 2}, f)
    cmd = [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config", cfg,
           "--infer", "--hparams", f"work_dir={work}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"--infer failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    m = re.search(r"^\| infer summary: (\{.*\})$", proc.stdout, re.M)
    if m is None:
        raise RuntimeError(f"no infer summary in the output:\n{proc.stdout[-4000:]}")
    summary = json.loads(m.group(1))
    gen_dir = os.path.join(work, "generated_0_")
    n_wavs = n_mels = 0
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        wavs = sorted(glob.glob(f"{gen_dir}/wavs/{key}_wavout/*.wav"))
        mels = sorted(glob.glob(f"{gen_dir}/mels/{key}_mel/*.npy"))
        if len(wavs) != len(UTT_FRAMES) or len(mels) != len(UTT_FRAMES):
            raise AssertionError(f"{key}: {len(wavs)} wavs, {len(mels)} mels")
        for wf, mf in zip(wavs, mels):
            mel = np.load(mf)
            with wave.open(wf) as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            if not np.isfinite(mel).all() or pcm.shape[0] != mel.shape[0] * 128:
                raise AssertionError(f"{wf}: {pcm.shape[0]} samples for "
                                     f"{mel.shape[0]} frames")
            if np.sqrt(np.mean(pcm.astype(np.float64) ** 2)) < 1.0:
                raise AssertionError(f"{wf} is silent")
            n_wavs, n_mels = n_wavs + 1, n_mels + 1
    n_calls = 5 * len(UTT_FRAMES)
    expected = 18 * len(voc["upsample_rates"]) * n_calls
    launches = summary["resblock_conv1d_launches"]
    emit("main_path", wavs=n_wavs, mels=n_mels, wall_s=wall,
         infer_compute_s=summary["compute_sec"], audio_s=summary["audio_sec"],
         rtf=summary["rtf"], rtf_wall=wall / summary["audio_sec"],
         max_memory_allocated=summary["max_memory_allocated"],
         vocoder_calls=n_calls, resblock_conv1d_launches=launches,
         expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return launches


def phase_card_vs_cpu(voc):
    import torch
    from neuralsvb_torch.data.datasets import MultiSpkEmbDataset
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.models.hifigan import HifiGanGenerator
    from neuralsvb_torch.models.svb_vae import SVBVAE
    from neuralsvb_torch.ops.pitch_utils import denorm_f0
    hp = set_hparams(config=os.path.join(WORK, "infer.yaml"),
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp) as h:
        ds = MultiSpkEmbDataset("test")
        batch = ds.collater([ds[0]])
        Tp = int(batch["prof_mel_lengths"][0])
        f0 = denorm_f0(batch["prof_f0"], batch["prof_uv"], h)[:, :Tp]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = SVBVAE(100, hidden_size=256, latent_size=128, fvae_hidden=192,
                       fvae_kernel=5, fvae_enc_layers=8, fvae_dec_layers=4,
                       mel_strides=(2, 1, 1), asr_enc_layers=2).eval()
        gen = HifiGanGenerator(
            upsample_rates=voc["upsample_rates"],
            upsample_kernel_sizes=voc["upsample_kernel_sizes"],
            upsample_initial_channel=voc["upsample_initial_channel"],
            resblock=voc["resblock"],
            resblock_kernel_sizes=voc["resblock_kernel_sizes"],
            resblock_dilation_sizes=voc["resblock_dilation_sizes"]).eval()
    res = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        g = gen.to(dev)
        t = {k: torch.as_tensor(batch[k], device=dev) for k in
             ("mels", "prof_mels", "pitch", "prof_pitch", "a2p_f0_alignment")}
        spk = torch.as_tensor(batch["multi_spk_emb"][:, 0], device=dev)
        with torch.no_grad():
            out = m(t["mels"], t["prof_mels"], t["pitch"], t["prof_pitch"], spk,
                    t["a2p_f0_alignment"], zero_noise=True)
            mel = out["a2p"]["mel_out"][:, :Tp]
            wav = g(mel, torch.as_tensor(f0, device=dev), zero_noise=True)
        res[dev] = (mel.cpu(), wav.cpu())
    mel_err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    wav_err = float((res["cuda"][1] - res["cpu"][1]).abs().max())
    ok = (mel_err <= 1e-3 and wav_err <= 1e-3
          and bool(torch.isfinite(res["cuda"][1]).all()))
    emit("card_vs_cpu", frames=Tp, mel_out_max_abs_err=mel_err,
         wav_max_abs_err=wav_err, tol=1e-3, ok=ok)
    if not ok:
        raise AssertionError(f"card vs CPU: mel {mel_err}, wav {wav_err}")


def main():
    if not os.path.isdir(os.path.join(REPO, "neuralsvb_torch")):
        raise SystemExit("chip_smoke.py runs from a checkout of the repository "
                         "(neuralsvb_torch/ not found beside it)")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke run "
                           "needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=name, device_count=torch.cuda.device_count(),
         nvidia_smi=smi)
    tf32(False)

    from neuralsvb_torch.ops import fused_resblock as fr
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    fr.build_kernel()
    ptxas = [ln.strip() for ln in fr.LIBRARY.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=fr.LIBRARY.build_seconds,
         flags=fr.NVCC_FLAGS, library=os.path.relpath(str(fr.LIBRARY.path), REPO),
         ptxas=ptxas)

    spec = fr.make_spec((3, 7, 11), ((1, 3, 5),) * 3)
    rows, worst = phase_kernel(fr, spec)
    voc = vocoder_keys()
    # the --infer process zeroes its count at test_start and reports it at
    # test_end: the count covers the main path's test loop only
    launches = phase_main_path(voc)
    phase_card_vs_cpu(voc)

    stage = rows[:len(STAGE_SHAPES)]
    print(json.dumps({"kernels": [{
        "name": "resblock_conv1d", "route": "cuda",
        "source": "neuralsvb_torch/csrc/fused_resblock.cu",
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": worst,
        "ms": sum(r["kernel_ms"] for r in stage),
        "plain_ms": sum(r["plain_ms"] for r in stage)}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
