"""FastSpeech2: text -> mel with duration and pitch losses; port of
``neuralsvb_tpu/tasks/fs2.py`` (reference: tasks/tts/fs2.py:29-506), the
``egs/egs_bases/{tts,singing}/fs2_torch.yaml`` recipes.

Each generator step runs ``FastSpeech2`` on the ground-truth durations
(``mel2ph``) and, with ``use_gt_f0``, the ground-truth f0 and uv (with
``pitch_type: cwt``, the f0 the ground-truth wavelet spectrum decodes to)
and adds:

- the mel losses of ``mel_loss`` (``l1``, ``ssim``);
- ``pdur``, the phone durations' log-domain MSE (``lambda_ph_dur``),
  ``sdur``, the sentence's (``lambda_sent_dur``), and ``wdur``, the
  words' where the batch has ``ph2word`` (``lambda_word_dur``);
- frame pitch: ``f0`` (L1 on the normalized f0, ``lambda_f0``) and ``uv``
  (BCE with logits, ``lambda_uv``); CWT pitch: ``C`` (the spectrum's L1
  or L2, ``cwt_loss``), ``uv``, ``f0_mean``, ``f0_std`` and, with
  ``cwt_add_f0_loss``, ``f0`` from the predicted spectrum;
- ``e``, the energy's L1 (``lambda_energy``) with ``use_energy_embed``.

Under data parallelism every masked mean is the global batch's
(``parallel/ddp.py``). ``--infer`` vocodes each test item's prediction
(``P``) and, with ``save_gt``, its ground truth (``G``) through the
registry's vocoder, saves the wavs and the predicted mel (``mels/mel``)
and, with ``save_f0``, the two f0 tracks the port's pitch tracker reads
from the wavs (``plot/[F0]<item>.npy``, and a PNG when matplotlib is
installed); it ends with ``| infer summary: {json}``. Validation renders
the vocoded prediction of its first ``num_valid_plots`` batches every
``valid_infer_interval`` steps (audio only: no figures).
"""

from __future__ import annotations

import json
import os
import time
from multiprocessing.pool import ThreadPool
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.jax2torch import fs2_from_jax
from ..data.datasets import FastSpeechDataset, maybe_concat_dataset
from ..hparams import hparams
from ..models.fs2 import FastSpeech2
from ..models.tts_modules import mel2ph_to_dur
from ..ops.cwt import cwt2f0_norm
from ..ops.fused_resblock import KERNEL_COUNTERS
from ..ops.pitch_utils import denorm_f0
from ..parallel import ddp
from ..utils.plot import spec_to_figure
from ..utils.profiling import RTFMeter
from .adv_base import AdversarialTaskBase
from .losses import abs_, add_mel_loss


def binary_cross_entropy_logits(logits, targets):
    """Elementwise BCE with logits, the JAX package's formula."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def masked_mean(x, w, min_den: float = 0.0):
    """sum(x * w) / max(sum(w), min_den) over the global batch."""
    return ddp.all_sum((x * w).sum()) / ddp.all_sum(w.sum()).clamp_min(min_den)


class FastSpeech2Task(AdversarialTaskBase):
    dataset_cls = FastSpeechDataset

    def build_generator(self):
        hp = hparams
        return FastSpeech2(
            dict_size=self._dict_size(), hidden_size=hp["hidden_size"],
            enc_layers=hp["enc_layers"], dec_layers=hp["dec_layers"],
            enc_ffn_kernel_size=hp["enc_ffn_kernel_size"],
            dec_ffn_kernel_size=hp["dec_ffn_kernel_size"], num_heads=hp["num_heads"],
            out_dims=hp["audio_num_mel_bins"],
            decoder_type="fft" if hp["decoder_type"] == "fft" else "conv",
            use_spk_id=hp["use_spk_id"], use_spk_embed=hp["use_spk_embed"],
            num_spk=hp["num_spk"], use_pitch_embed=hp["use_pitch_embed"],
            use_energy_embed=hp["use_energy_embed"], use_uv=hp["use_uv"],
            pitch_type=hp["pitch_type"], predictor_hidden=hp["predictor_hidden"],
            predictor_kernel=hp["predictor_kernel"], predictor_layers=hp["predictor_layers"],
            dur_predictor_kernel=hp["dur_predictor_kernel"],
            dur_predictor_layers=hp["dur_predictor_layers"],
            predictor_dropout=hp["predictor_dropout"], predictor_grad=hp["predictor_grad"],
            dropout=hp["dropout"], f0_mean=hp.get("f0_mean") or 220.0,
            f0_std=hp.get("f0_std") or 60.0, pitch_norm=hp["pitch_norm"])

    def _from_jax(self, state: dict):
        return fs2_from_jax(state["params"], state.get("batch_stats") or {})

    # ------------------------------------------------------------------
    def prep_batch(self, batch, infer: bool = False):
        hp = hparams
        if batch.get("txt_tokens") is None or batch.get("mel2ph") is None:
            raise ValueError("FastSpeech2 needs phone tokens and mel2ph: binarize with "
                             "with_txt and with_align")
        real = torch.get_default_dtype()
        b = {"txt_tokens": self._dev(batch["txt_tokens"], torch.long),
             "mels": self._dev(batch["mels"], real),
             "mel2ph": self._dev(batch["mel2ph"], torch.long),
             "f0": self._dev(batch["f0"], real), "uv": self._dev(batch["uv"], real),
             "energy": self._dev(batch["energy"], real)}
        if hp["pitch_type"] == "cwt" and "cwt_spec" in batch:
            for k in ("cwt_spec", "f0_mean", "f0_std"):
                b[k] = self._dev(batch[k], real)
        if "ph2word" in batch:
            b["ph2word"] = self._dev(batch["ph2word"], torch.long)
        if hp["use_spk_id"]:
            b["spk"] = self._dev(batch["spk_ids"], torch.long)
        elif hp["use_spk_embed"]:
            b["spk"] = self._dev(batch["spk_embed"], real)
        return b

    def forward_losses(self, b, generator, train: bool):
        hp = hparams
        f0 = b["f0"] if hp["use_gt_f0"] else None
        uv = b["uv"] if hp["use_gt_f0"] else None
        if hp["pitch_type"] == "cwt" and "cwt_spec" in b:
            # the ground truth's f0 is decoded from its wavelet spectrum
            # (reference: fs2.py:119-123 run_model)
            f0 = cwt2f0_norm(b["cwt_spec"], b["f0_mean"], b["f0_std"], b["mel2ph"], hp)
            uv = b["uv"]
        out = self.model(b["txt_tokens"], b["mel2ph"], b.get("spk"), f0, uv, b.get("energy"),
                         generator=generator)
        losses: Dict[str, torch.Tensor] = {}
        add_mel_loss(self.loss_and_lambda, out["mel_out"], b["mels"], losses)
        self._dur_loss(out, b, losses)
        if hp["use_pitch_embed"]:
            self._pitch_loss(out, b, losses)
        if hp.get("use_energy_embed"):
            self._energy_loss(out, b, losses)
        return losses, {"": out["mel_out"]}, {"": b["mels"]}

    def _dur_loss(self, out, b, losses):
        hp = hparams
        tokens = b["txt_tokens"]
        nonpadding = (tokens != 0).to(out["dur"].dtype)
        dur_gt = mel2ph_to_dur(b["mel2ph"], tokens.shape[1]).to(out["dur"].dtype) * nonpadding
        losses["pdur"] = masked_mean((out["dur"] - torch.log(dur_gt + 1)) ** 2,
                                     nonpadding) * hp["lambda_ph_dur"]
        dur_pred_lin = (torch.exp(out["dur"]) - 1).clamp_min(0) * nonpadding
        if hp["lambda_sent_dur"] > 0:
            sd = (torch.log(dur_pred_lin.sum(-1) + 1) - torch.log(dur_gt.sum(-1) + 1)) ** 2
            losses["sdur"] = ddp.global_mean(sd) * hp["lambda_sent_dur"]
        if hp.get("lambda_word_dur", 0) > 0 and b.get("ph2word") is not None:
            # word durations as segment sums over ph2word (1-based, 0 = pad;
            # reference: fs2.py:208-216)
            ph2word = b["ph2word"]
            oh = F.one_hot(ph2word, int(ph2word.max()) + 1).to(dur_gt.dtype)
            wd_p = torch.einsum("bt,btw->bw", dur_pred_lin, oh)[:, 1:]
            wd_g = torch.einsum("bt,btw->bw", dur_gt, oh)[:, 1:]
            keep = (wd_g > 0).to(dur_gt.dtype)
            wl = masked_mean((torch.log(wd_p + 1) - torch.log(wd_g + 1)) ** 2, keep, 1.0)
            losses["wdur"] = wl * hp["lambda_word_dur"]

    def _energy_loss(self, out, b, losses):
        """reference: fs2.py add_energy, the EnergyPredictor's L1."""
        if "energy_pred" not in out or b.get("energy") is None:
            return
        nonpadding = (b["mel2ph"] != 0).to(out["energy_pred"].dtype)
        losses["e"] = masked_mean(abs_(out["energy_pred"] - b["energy"]), nonpadding,
                                  1.0) * hparams.get("lambda_energy", 0.0)

    def _pitch_loss(self, out, b, losses):
        hp = hparams
        nonpadding = (b["mel2ph"] != 0).to(out["mel_out"].dtype)
        if hp["pitch_type"] == "cwt":
            return self._cwt_pitch_loss(out, b, losses, nonpadding)
        pred = out["pitch_pred"]
        losses["f0"] = masked_mean(abs_(pred[:, :, 0] - b["f0"]), nonpadding,
                                   1.0) * hp["lambda_f0"]
        if hp["use_uv"] and pred.shape[-1] > 1:
            losses["uv"] = masked_mean(binary_cross_entropy_logits(pred[:, :, 1], b["uv"]),
                                       nonpadding, 1.0) * hp["lambda_uv"]

    def _cwt_pitch_loss(self, out, b, losses, nonpadding):
        """The wavelet spectrum, uv and the utterance's statistics
        (reference: tasks/tts/fs2.py:233-250)."""
        hp = hparams
        if "cwt_spec" not in b:
            return
        cwt_g = b["cwt_spec"]
        T = min(cwt_g.shape[1], out["cwt"].shape[1])
        cwt_pred = out["cwt"][:, :T, :10]
        diff = cwt_pred - cwt_g[:, :T]
        c = abs_(diff) if hp.get("cwt_loss", "l1") == "l1" else diff ** 2
        losses["C"] = ddp.global_mean(c) * hp["lambda_f0"]
        if hp["use_uv"]:
            losses["uv"] = masked_mean(
                binary_cross_entropy_logits(out["cwt"][:, :T, -1], b["uv"][:, :T]),
                nonpadding[:, :T], 1.0) * hp["lambda_uv"]
        losses["f0_mean"] = ddp.global_mean(abs_(out["f0_mean"] - b["f0_mean"])) * hp["lambda_f0"]
        losses["f0_std"] = ddp.global_mean(abs_(out["f0_std"] - b["f0_std"])) * hp["lambda_f0"]
        if hp.get("cwt_add_f0_loss"):
            f0_cwt = cwt2f0_norm(cwt_pred, out["f0_mean"], out["f0_std"], b["mel2ph"], hp)
            losses["f0"] = masked_mean(abs_(f0_cwt - b["f0"]), nonpadding,
                                       1.0) * hp["lambda_f0"]

    # ------------------------------------------------------------------
    def _get_vocoder(self):
        if self.vocoder is None:
            from ..vocoders.base import get_vocoder_cls
            self.vocoder = get_vocoder_cls(hparams)(dict(hparams), device=self.device)
        return self.vocoder

    def vis_validation(self, batch, fakes, gts, batch_idx):
        """The mel ``gt|pred`` figure and the vocoded prediction of the first
        ``num_valid_plots`` batches every ``valid_infer_interval`` steps
        (reference: fs2.py validation plots)."""
        if (self.logger is None or self.global_step % hparams["valid_infer_interval"] != 0
                or batch_idx >= hparams.get("num_valid_plots", 0)):
            return
        L = int(batch["mel_lengths"][0])
        if self.logger.writes_figures:
            fig = spec_to_figure(torch.cat([gts[""][0, :L].float(), fakes[""][0, :L].float()], -1),
                                 vmin=hparams["mel_vmin"], vmax=hparams["mel_vmax"],
                                 title="gt|pred")
            self.logger.add_figure(f"mel_{batch_idx}", fig, self.global_step)
        f0 = denorm_f0(self._dev(batch["f0"], torch.float32),
                       self._dev(batch["uv"], torch.float32), hparams)[0, :L]
        wav = self._get_vocoder().spec2wav(fakes[""][0, :L], f0=f0)
        self.vocoder_calls += 1
        self.logger.add_audio(f"wav_{batch_idx}", wav.cpu().numpy(), self.global_step,
                              hparams["audio_sample_rate"])

    # ------------------------------------------------------------------
    def train_dataloader(self):
        ds = maybe_concat_dataset(self.dataset_cls, hparams["train_set_name"], shuffle=True)
        return self.build_dataloader(ds, True, hparams["max_tokens"], hparams["max_sentences"],
                                     endless=hparams["endless_ds"], n_devices=self.n_devices)

    def val_dataloader(self):
        ds = self.dataset_cls(hparams["valid_set_name"], shuffle=False)
        max_vt, max_vs = hparams["max_valid_tokens"], hparams["max_valid_sentences"]
        return self.build_dataloader(ds, False, hparams["max_tokens"] if max_vt == -1 else max_vt,
                                     None if max_vs == -1 else max_vs)

    def test_dataloader(self):
        ds = self.dataset_cls(hparams["test_set_name"], shuffle=False)
        return self.build_dataloader(ds, max_sentences=1, use_batch_by_size=False)

    # ------------------------------------------------------------------
    # inference (reference: tasks/tts/fs2.py after_infer)
    def test_start(self):
        self.saving_result_pool = ThreadPool(8)
        self.saving_results_futures = []
        self._get_vocoder()
        self.results_id = 0
        self._n_infer_utts, self._rtf = 0, RTFMeter()
        for c in KERNEL_COUNTERS:  # test_end reports the test loop's launches
            c.launches = 0
        self.vocoder_calls = 0

    @torch.no_grad()
    def test_step(self, batch, batch_idx: int):
        if batch["nsamples"] != 1:
            raise ValueError("inference supports batch_size=1")
        hp = hparams
        self.model.eval()
        t0 = time.perf_counter()
        b = self.prep_batch(batch, infer=True)
        use_gt_dur = hp.get("use_gt_dur", True)
        use_gt_f0 = hp.get("use_gt_f0", True)
        out = self.model(b["txt_tokens"], b["mel2ph"] if use_gt_dur else None, b.get("spk"),
                         b["f0"] if use_gt_f0 else None, b["uv"] if use_gt_f0 else None,
                         b.get("energy"), infer=True,
                         max_frames=None if use_gt_dur else batch["mels"].shape[1],
                         generator=self.generator)
        T = int(batch["mel_lengths"][0])
        mel_pred = out["mel_out"][0, :T]
        f0 = denorm_f0(b["f0"], b["uv"], hp)[0, :T]
        voc = self._get_vocoder()
        wavs = {"P": voc.spec2wav(mel_pred, f0=f0)}
        if hp.get("save_gt", True):
            wavs["G"] = voc.spec2wav(b["mels"][0, :T], f0=f0)
        self.vocoder_calls += len(wavs)
        wavs = {k: v.cpu().numpy() for k, v in wavs.items()}
        mel_np = mel_pred.cpu().numpy()
        # .cpu() synchronized
        self._rtf.add(time.perf_counter() - t0, len(wavs["P"]) / hp["audio_sample_rate"])
        self._n_infer_utts += 1
        gen_dir = os.path.join(hp["work_dir"], f"generated_{self.global_step}_{hp['gen_dir_name']}")
        base_fn = f"[{self.results_id:06d}][{batch['item_name'][0]}]".replace(" ", "_")
        self.results_id += 1
        from .svb_vae_task import SVBVAEMleTask
        self.saving_results_futures.append(self.saving_result_pool.apply_async(
            SVBVAEMleTask.save_result,
            args=[{f"{k.lower()}_wavout": v for k, v in wavs.items()}, base_fn, gen_dir,
                  {"mel": mel_np}]))
        if hp.get("save_f0") and "G" in wavs:
            self.saving_results_futures.append(self.saving_result_pool.apply_async(
                self._save_f0_plot,
                args=[wavs["P"], mel_np, wavs["G"], b["mels"][0, :T].cpu().numpy(), gen_dir,
                      base_fn, self.device]))
        return {"item_name": batch["item_name"][0]}

    @staticmethod
    def _save_f0_plot(wav_pred, mel_pred, wav_gt, mel_gt, gen_dir, base_fn, device):
        """The predicted and ground-truth f0 tracked from the vocoded wavs
        (reference: fs2.py:432-447): ``plot/[F0]<item>.npy`` ([2, T]: P, G),
        and the overlay as a PNG when matplotlib is installed."""
        from ..ops.pitch import get_pitch
        f0_p, _ = get_pitch(wav_pred, mel_pred, hparams, device)
        f0_g, _ = get_pitch(wav_gt, mel_gt, hparams, device)
        os.makedirs(f"{gen_dir}/plot", exist_ok=True)
        np.save(f"{gen_dir}/plot/[F0]{base_fn}.npy", np.stack([f0_p, f0_g]))
        try:  # the figure API, not pyplot: the saving pool runs threads
            from matplotlib.figure import Figure
        except ImportError:
            return
        fig = Figure()
        ax = fig.subplots()
        ax.plot(f0_p, label="f0 P")
        ax.plot(f0_g, label="f0 G")
        ax.legend()
        fig.tight_layout()
        fig.savefig(f"{gen_dir}/plot/[F0]{base_fn}.png", format="png")

    def test_end(self, outputs):
        self.saving_result_pool.close()
        for f in self.saving_results_futures:
            f.get()
        self.saving_result_pool.join()
        summary = {"device": str(self.device), "utts": self._n_infer_utts,
                   "vocoder_calls": self.vocoder_calls, "audio_sec": self._rtf.audio_sec,
                   "compute_sec": self._rtf.compute_sec, "rtf": self._rtf.rtf,
                   **{f"{c.__name__}_launches": c.launches for c in KERNEL_COUNTERS}}
        if self.device.type == "cuda":
            summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        print(f"| infer summary: {json.dumps(summary)}")
        return summary
