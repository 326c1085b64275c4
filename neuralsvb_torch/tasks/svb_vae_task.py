"""SVB VAE inference task: the a2a/p2p/a2p serving path of the flagship
recipe; port of the inference subset of ``neuralsvb_tpu/tasks/svb_vae_task.py``
(reference: tasks/singing/svb_vae_task.py:48-726).

packed test split -> ``SVBVAE`` forward for the three ways -> HiFiGAN-NSF
-> ``generated_{step}_{gen_dir_name}/wavs/{gt_a,gt_p,a2a,p2p,a2p}_wavout``
and ``mels/*_mel``. Everything after the collated numpy batch runs on the
``device`` hparam's device, f0 denormalization and the NSF source included.
"""

from __future__ import annotations

import json
import os
import time
from multiprocessing.pool import ThreadPool

import numpy as np
import torch

from ..convert.checkpoint import load_into, load_state_dict, newest_checkpoint
from ..data.datasets import MultiSpkEmbDataset
from ..hparams import hparams, resolve_device
from ..models.svb_vae import SVBVAE, WAYS
from ..ops.fused_resblock import lrelu_bf16, resblock_conv1d, resblock_conv1d_bf16
from ..ops.pitch_utils import denorm_f0
from .base_task import BaseTask


class SVBVAEMleTask(BaseTask):
    """Global latent + MLE-trained z mapping: the flagship
    (reference: SVBVAEMleTask:543, vae_global_mle_eng.yaml)."""

    def __init__(self):
        super().__init__()
        self.device = resolve_device(hparams.get("device"))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(hparams.get("seed", 1234)))
        self.zero_noise = bool(hparams.get("zero_noise", False))
        self.vocoder = None

    def _dict_size(self):
        fn = os.path.join(hparams["binary_data_dir"], "phone_set.json")
        if os.path.exists(fn):
            with open(fn) as f:
                return len(json.load(f)) + 10
        print(f"| WARNING: {fn} missing; defaulting ASR dict size to 100.")
        return 100

    def build_model(self):
        hp = hparams
        with torch.random.fork_rng(devices=[]):  # seeded random init
            torch.manual_seed(int(hp.get("seed", 1234)))
            model = SVBVAE(
                dict_size=self._dict_size(),
                hidden_size=hp["hidden_size"],
                num_mel_bins=hp["audio_num_mel_bins"],
                latent_size=hp["latent_size"],
                fvae_hidden=hp["fvae_enc_dec_hidden"],
                fvae_kernel=hp["fvae_kernel_size"],
                fvae_enc_layers=hp["fvae_enc_n_layers"],
                fvae_dec_layers=hp["fvae_dec_n_layers"],
                frames_multiple=hp["frames_multiple"],
                mel_strides=tuple(hp["mel_strides"]),
                asr_enc_layers=hp["asr_enc_layers"],
                asr_last_norm=hp["asr_last_norm"])
        self.model = model.to(self.device).eval().requires_grad_(False)
        return self.model

    def restore(self) -> int:
        ckpt = newest_checkpoint(hparams["work_dir"]) if hparams.get("work_dir") else None
        if ckpt is None:
            print(f"| WARNING: no checkpoint in '{hparams.get('work_dir')}'; "
                  "running SVBVAE with seeded random init.")
            return 0
        load_into(self.model, load_state_dict(ckpt, "model"), "SVBVAE")
        print(f"| Restored ckpt: {ckpt}")
        self.model.to(self.device)
        return int(ckpt.rsplit("steps_", 1)[1].split(".")[0])

    def _prep_batch(self, batch):
        """Collated numpy batch -> model inputs on the device; inference
        takes speaker-embedding column 0 (reference: svb_vae_task.py:139-143)."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        return {
            "mels": dev(batch["mels"], torch.float32),
            "prof_mels": dev(batch["prof_mels"], torch.float32),
            "pitch": dev(batch["pitch"], torch.long),
            "prof_pitch": dev(batch["prof_pitch"], torch.long),
            "a2p_f0_alignment": dev(batch["a2p_f0_alignment"], torch.long),
            "spk_emb": dev(batch["multi_spk_emb"][:, 0], torch.float32),
        }

    @torch.no_grad()
    def forward(self, b):
        return self.model(b["mels"], b["prof_mels"], b["pitch"], b["prof_pitch"],
                          b["spk_emb"], b["a2p_f0_alignment"],
                          disable_map=bool(hparams.get("disable_map", False)),
                          generator=self.generator, zero_noise=self.zero_noise)

    # ------------------------------------------------------------------
    def test_start(self):
        from ..vocoders.base import get_vocoder_cls
        self.saving_result_pool = ThreadPool(8)
        self.saving_results_futures = []
        self.vocoder = get_vocoder_cls(hparams)(dict(hparams), device=self.device)
        self.results_id = 0
        self._n_infer_utts = 0
        self._audio_sec = 0.0
        self._compute_sec = 0.0
        # test_end reports the test loop's launches
        resblock_conv1d.launches = resblock_conv1d_bf16.launches = lrelu_bf16.launches = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def test_step(self, batch, batch_idx: int):
        t0 = time.perf_counter()
        # the reference resets the result index at every test_step
        self.results_id = 0
        b = self._prep_batch(batch)
        out = self.forward(b)

        def dev(k):
            return torch.as_tensor(batch[k], device=self.device)
        f0s = {"a2a": denorm_f0(dev("f0"), dev("uv"), hparams),
               "p2p": denorm_f0(dev("prof_f0"), dev("prof_uv"), hparams)}
        f0s["a2p"] = f0s["p2p"]
        gen_dir = os.path.join(
            hparams["work_dir"],
            f"generated_{self.global_step}_{hparams['gen_dir_name']}")
        prefix = "disable_map_" if hparams.get("disable_map") else ""
        voc = self.vocoder
        for i in range(batch["nsamples"]):
            Ta = int(batch["mel_lengths"][i])
            Tp = int(batch["prof_mel_lengths"][i])
            lens = {"a2a": Ta, "p2p": Tp, "a2p": Tp}
            wavs = {
                "gt_a_wavout": voc.spec2wav(b["mels"][i, :Ta], f0=f0s["a2a"][i, :Ta],
                                            zero_noise=self.zero_noise),
                "gt_p_wavout": voc.spec2wav(b["prof_mels"][i, :Tp],
                                            f0=f0s["p2p"][i, :Tp],
                                            zero_noise=self.zero_noise),
            }
            mels = {"gt_a_mel": batch["mels"][i][:Ta],
                    "gt_p_mel": batch["prof_mels"][i][:Tp]}
            for way in WAYS:
                L = lens[way]
                mel = out[way]["mel_out"][i, :L]
                wavs[f"{way}_wavout"] = voc.spec2wav(mel, f0=f0s[way][i, :L],
                                                     zero_noise=self.zero_noise)
                mels[f"{way}_mel"] = mel
            wavs = {k: v.cpu().numpy() for k, v in wavs.items()}
            mels = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in mels.items()}
            base_fn = f"[{self.results_id:06d}][{batch['item_name'][i]}][P]".replace(" ", "_")
            self.results_id += 1
            self._n_infer_utts += 1
            self._audio_sec += Tp * hparams["hop_size"] / hparams["audio_sample_rate"]
            self.saving_results_futures.append(
                self.saving_result_pool.apply_async(
                    self.save_result, args=[wavs, base_fn, gen_dir, mels, prefix]))
        self._compute_sec += time.perf_counter() - t0  # .cpu() above synchronized
        return {"item_name": batch["item_name"][0]}

    @staticmethod
    def save_result(wavs_dict, base_fn, gen_dir, mels_dict, prefix=""):
        from ..ops.audio import save_wav
        sr = hparams["audio_sample_rate"]
        for key, wav in wavs_dict.items():
            d = f"{gen_dir}/wavs/{prefix}{key}"
            os.makedirs(d, exist_ok=True)
            save_wav(wav, f"{d}/{base_fn}.wav", sr,
                     norm=hparams.get("out_wav_norm", False))
        for key, mel in mels_dict.items():
            d = f"{gen_dir}/mels/{prefix}{key}"
            os.makedirs(d, exist_ok=True)
            np.save(f"{d}/{base_fn}.npy", mel)

    def test_end(self, outputs):
        self.saving_result_pool.close()
        for f in self.saving_results_futures:
            f.get()
        self.saving_result_pool.join()
        summary = {
            "device": str(self.device),
            "utts": self._n_infer_utts,
            "audio_sec": self._audio_sec,
            "compute_sec": self._compute_sec,
            "rtf": self._compute_sec / max(self._audio_sec, 1e-9),
            "resblock_conv1d_launches": resblock_conv1d.launches,
            "resblock_conv1d_bf16_launches": resblock_conv1d_bf16.launches,
            "lrelu_bf16_launches": lrelu_bf16.launches,
        }
        if self.device.type == "cuda":
            summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        print(f"| infer summary: {json.dumps(summary)}")
        return summary

    # ------------------------------------------------------------------
    def test_dataloader(self):
        ds = MultiSpkEmbDataset(hparams["test_set_name"], shuffle=False)
        return self.build_dataloader(ds, int(hparams.get("infer_batch_size") or 1))
