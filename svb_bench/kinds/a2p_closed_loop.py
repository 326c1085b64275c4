"""a2p serving, closed loop: one client sends an amateur take, waits for its
professional-sounding wav on the host, and sends the next.

A request: ``SVBVAEMleTask._prep_batch`` of a batch of one, ``forward``
(the a2a, p2p and a2p ways; a2p needs the other two), ``HifiGAN.spec2wav``
of the a2p mel with the professional F0, and the wav copied to the host.
Its latency runs from handing over the inputs to the wav on the host. The
FVAE's samples and the NSF source's noise come from generators the
benchmark seeds per request, and the reference draws the same.

Traffic keys: ``deck`` requests (``synth.a2p_deck``: ``prof_seconds``,
``amateur_factor``, ``max_frames``) served in a fresh order of the seed on
every pass; ``trace_requests`` profiled at the start of a ``--trace 1``
window; ``check_requests`` compared with the reference after the window
(the longest completed request and others drawn from the seed);
``limits`` of the comparison."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import flops, stats, synth
from ..correct import rel_err
from ..harness import Result, span, sync, tf32
from ..weights import init_spec, load_seeded, seeded_state


WINDOW, WARMUP, WEIGHTS = 0, 1, 2  # what a derived seed is for


def _request_seeds(seed: int, i: int, use: int = WINDOW):
    """Two 32-bit seeds (SVB model, vocoder) of request ``i`` of ``use``."""
    return [int(x) for x in
            np.random.SeedSequence([seed % 2 ** 63, use, i]).generate_state(2)]


def _svb_kwargs(hp: dict) -> dict:
    return dict(hidden_size=hp["hidden_size"],
                num_mel_bins=hp["audio_num_mel_bins"], latent_size=hp["latent_size"],
                fvae_hidden=hp["fvae_enc_dec_hidden"], fvae_kernel=hp["fvae_kernel_size"],
                fvae_enc_layers=hp["fvae_enc_n_layers"], fvae_dec_layers=hp["fvae_dec_n_layers"],
                frames_multiple=hp["frames_multiple"], mel_strides=list(hp["mel_strides"]),
                asr_enc_layers=hp["asr_enc_layers"], asr_last_norm=hp["asr_last_norm"])


def _gen_kwargs(voc: dict) -> dict:
    return dict(upsample_rates=list(voc["upsample_rates"]),
                upsample_kernel_sizes=list(voc["upsample_kernel_sizes"]),
                upsample_initial_channel=voc["upsample_initial_channel"],
                resblock=str(voc["resblock"]),
                resblock_kernel_sizes=list(voc["resblock_kernel_sizes"]),
                resblock_dilation_sizes=[list(d) for d in voc["resblock_dilation_sizes"]],
                use_pitch_embed=voc["use_pitch_embed"],
                audio_sample_rate=voc["audio_sample_rate"],
                num_mels=voc["audio_num_mel_bins"])


def _reference_models(svb_kw, gen_kw):
    from ..reference.hifigan import HifiGanGenerator
    from ..reference.svb_vae import SVBVAE
    with torch.device("meta"):
        svb, gen = SVBVAE(**svb_kw), HifiGanGenerator(**gen_kw)
    return svb, gen


def run(ctx) -> Result:
    import yaml
    from neuralsvb_torch.hparams import hparams
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    from neuralsvb_torch.vocoders.hifigan import HifiGAN, pick_bucket

    traffic, dev = ctx.traffic, ctx.device
    voc_cfg = ctx.config["vocoder"]
    voc_dir = os.path.join(ctx.tmp, "vocoder")
    os.makedirs(voc_dir, exist_ok=True)
    with open(os.path.join(voc_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(voc_cfg, f)
    hparams.clear()
    hparams.update(ctx.config["hparams"])
    hparams.update(device=dev.type, seed=ctx.seed % 2 ** 31, vocoder_ckpt=voc_dir,
                   work_dir="", pretrain_asr_ckpt="",
                   binary_data_dir=os.path.join(ctx.tmp, "no_data"))

    ctx.mark("import")
    task = SVBVAEMleTask()
    task.build_model()
    voc = HifiGAN(dict(hparams), device=dev)
    ctx.mark("build")
    svb_kw = _svb_kwargs(hparams)
    gen_kw = _gen_kwargs(voc.config)
    ref_svb, ref_gen = _reference_models(svb_kw, gen_kw)
    w_seed = _request_seeds(ctx.seed, 0, WEIGHTS)
    load_seeded(task.model, seeded_state(init_spec(ref_svb), w_seed[0], dev))
    load_seeded(voc.model, seeded_state(init_spec(ref_gen), w_seed[1], dev))

    ctx.mark("weights")
    deck = synth.a2p_deck(traffic, ctx.seed)
    order_rng = np.random.RandomState(ctx.seed % 2 ** 32)
    ctx.mark("inputs")

    def serve(i, r, events=None, use=WINDOW):
        """One request; its inputs are on the host, as a client hands them."""
        g_svb, g_voc = _request_seeds(ctx.seed, i, use)
        task.generator.manual_seed(g_svb)
        voc.generator.manual_seed(g_voc)
        with span("prep"):
            b = task._prep_batch(r)
        if events is not None:
            events[0].record()
        with span("forward"):
            out = task.forward(b)
        mel = out["a2p"]["mel_out"][0, : r["t_p"]]
        if events is not None:
            events[1].record()
        with span("spec2wav"):
            wav = voc.spec2wav(mel, f0=r["prof_f0"])
        if events is not None:
            events[2].record()
        with span("to_host"):
            return mel, wav.cpu().numpy()

    # set-up's warm-up: the whole deck once (every length the window serves)
    for j, r in enumerate(deck):
        serve(j, r, use=WARMUP)
    sync(dev)
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - ctx.t_process

    done = []  # (request index, deck index, latency s)
    keep = _Keeper(int(traffic["check_requests"]) - 1, ctx.seed, deck)
    events = []
    prof = None
    n_trace = int(traffic["trace_requests"]) if ctx.trace else 0
    order: list = []
    t0 = time.perf_counter()
    i = 0
    while True:
        if i == n_trace and prof is not None:
            sync(dev)
            win.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            t0 = time.perf_counter()  # a traced run measures after its profile
        if i >= n_trace and time.perf_counter() - t0 >= ctx.seconds:
            break
        if i == 0 and n_trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            win = span("window")
            win.__enter__()
        if not order:
            order = list(order_rng.permutation(len(deck)))
        k = order.pop()
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if ctx.trace and i >= n_trace and dev.type == "cuda" else None)
        ts = time.perf_counter()
        mel, wav = serve(i, deck[k], ev)
        lat = time.perf_counter() - ts
        done.append((i, k, lat))
        if i >= n_trace:
            keep.offer(i, k, mel, wav)
            if ev is not None:
                events.append((k, ev))
        del mel, wav
        i += 1
    t1 = time.perf_counter()
    window = [d for d in done if d[0] >= n_trace]
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    audio = [deck[k]["t_p"] * synth.HOP / synth.SR for _, k, _ in window]
    lats = [lat for _, _, lat in window]
    res = Result(setup_s=setup_s, attempted=len(window), failed=0,
                 memory_peak_bytes=mem_peak)
    res.e2e = {"audio_s_per_s": sum(audio) / (t1 - t0),
               "latency_p95_ms": stats.percentile(lats, 95) * 1e3}
    res.record = {"audio_s": audio, "latency_s": lats}
    if prof is not None:
        from ..trace import Trace
        res.trace = Trace.from_profile(prof)
        res.record["cluster_least_s"] = sum(_cluster_least_s(gen_kw, pick_bucket(deck[k]["t_p"]))
                                            for _, k, _ in done[:n_trace])
        sync(dev)
        res.record["forward_ms"] = [e[0].elapsed_time(e[1]) for _, e in events]
        res.record["spec2wav_ms"] = [e[1].elapsed_time(e[2]) for _, e in events]
        res.record["events_audio_s"] = [deck[k]["t_p"] * synth.HOP / synth.SR for k, _ in events]
        least = {}
        for _, k, _ in window:
            if k not in least:
                least[k] = flops.request_least_s(svb_kw, gen_kw, deck[k]["t_a"], deck[k]["t_p"])
        res.record["least_s"] = [least[k] for _, k, _ in window]

    # the comparison, once the window has closed and the program is freed
    check = keep.sample()
    del task, voc, done, window, events, keep
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res.checks = _compare(ctx, check, deck, svb_kw, gen_kw, w_seed)
    return res


def _cluster_least_s(gen_kw, bucket: int) -> float:
    """The cluster's least time at a vocoder call's bucketed frames."""
    args = (1, flops.stage_shapes(bucket, gen_kw["upsample_rates"],
                                  gen_kw["upsample_initial_channel"]),
            gen_kw["resblock_kernel_sizes"], gen_kw["resblock_dilation_sizes"])
    return max(flops.cluster_flops(*args) / flops.PEAK_BF16,
               flops.cluster_bytes(*args) / flops.PEAK_HBM)


class _Keeper:
    """The outputs the comparison reads: a uniform sample of ``n`` of the
    window's completed requests (reservoir sampling from the seed) and the
    longest completed request; every other output is dropped at once."""

    def __init__(self, n: int, seed: int, deck):
        self.n, self.deck, self.seen = n, deck, 0
        self.rng = np.random.RandomState((seed + 7) % 2 ** 32)
        self.kept, self.longest = [], None

    def offer(self, i, k, mel, wav):
        item = (i, k, mel, wav)
        if self.longest is None or self.deck[k]["t_p"] > self.deck[self.longest[1]]["t_p"]:
            self.longest = item
        self.seen += 1
        if len(self.kept) < self.n:
            self.kept.append(item)
        else:
            j = self.rng.randint(0, self.seen)
            if j < self.n:
                self.kept[j] = item

    def sample(self):
        """{request index: (deck index, mel on the host, wav)}."""
        items = self.kept + ([self.longest] if self.longest else [])
        return {i: (k, mel.float().cpu(), wav) for i, k, mel, wav in items}


def _compare(ctx, check, deck, svb_kw, gen_kw, w_seed):
    """Worst relative L2 gap of the a2p mel and of the wav, program against
    the reference (or, with ``--control 1``, the reference in the precision
    below the configuration's against the reference)."""
    from ..reference.hifigan import HifiGanGenerator, pick_bucket
    from ..reference.svb_vae import SVBVAE
    dev = ctx.device
    with torch.device(dev):
        svb = SVBVAE(**svb_kw).eval()
        gen = HifiGanGenerator(**gen_kw).eval()
    load_seeded(svb, seeded_state(init_spec(svb), w_seed[0], dev))
    load_seeded(gen, seeded_state(init_spec(gen), w_seed[1], dev))

    def reference(i, r, low: bool):
        g_svb, g_voc = _request_seeds(ctx.seed, i)
        gs, gv = torch.Generator(device=dev), torch.Generator(device=dev)
        gs.manual_seed(g_svb)
        gv.manual_seed(g_voc)
        t = {k: torch.as_tensor(r[k], device=dev) for k in
             ("mels", "prof_mels", "pitch", "prof_pitch", "a2p_f0_alignment")}
        emb = torch.as_tensor(r["multi_spk_emb"][:, 0], device=dev)
        # the configuration's cluster operands: bf16 on the card (the port
        # picks float32 on the CPU, where the CPU tests run)
        gen.operand = (torch.float8_e4m3fn if low else
                       torch.bfloat16 if dev.type == "cuda" else None)
        with tf32(low), torch.no_grad():
            out = svb(t["mels"].float(), t["prof_mels"].float(), t["pitch"], t["prof_pitch"],
                      emb, t["a2p_f0_alignment"], generator=gs)
            mel = out["a2p"]["mel_out"][0, : r["t_p"]]
            T = mel.shape[0]
            Tb = pick_bucket(T)
            mel_p = torch.nn.functional.pad(mel, (0, 0, 0, Tb - T))
            f0 = torch.nn.functional.pad(torch.as_tensor(r["prof_f0"], device=dev), (0, Tb - T))
            wav = gen(mel_p[None], f0[None], generator=gv)[0, : T * gen.hop]
        return mel.cpu(), wav.cpu().numpy()

    worst = {"mel": 0.0, "wav": 0.0}
    for i, (k, mel, wav) in sorted(check.items()):
        ref_mel, ref_wav = reference(i, deck[k], False)
        if ctx.control:
            mel, wav = reference(i, deck[k], True)
        worst["mel"] = max(worst["mel"], rel_err(mel.numpy(), ref_mel.numpy()))
        worst["wav"] = max(worst["wav"], rel_err(wav, ref_wav))
    limits = ctx.traffic["limits"]
    return [("a2p_mel_rel_l2", worst["mel"], limits["a2p_mel_rel_l2"]),
            ("wav_rel_l2", worst["wav"], limits["wav_rel_l2"])]
