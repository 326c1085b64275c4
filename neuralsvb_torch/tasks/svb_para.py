"""The parallel-data SVB task over the PPG regression model; port of
``SVBParaTask`` in ``neuralsvb_tpu/tasks/svb_para.py`` (reference:
tasks/singing/svb_para.py:52-369), the base of ``VCPPGTask`` and
``SVBPPGTask``.

Training runs ``ParaSVBPPG`` on the ``concurrent_ways`` (a2a, p2p and a2p by
default): each way decodes the target side's pitch and energy from the
source side's content (a2p gathers the amateur PPG through the DTW
alignment), with the mel losses of ``mel_loss`` per way, and adds the
ASR's CE losses on the amateur and professional mels (``asr_a``,
``asr_p``) when the batch has phone tokens. Validation vocodes the first
batches' fakes through the registry's vocoder where the batch has a
professional side; ``--infer`` renders every way and both ground truths.

The six subclasses (JAX: ``svb_para.py:290-390``; no recipe names them,
they run through ``task_cls`` on ``egs/egs_bases/vc/vc_ppg_torch.yaml``):

- ``ParaPPGPreExpTask`` and ``ParaAlignedPPGTask``: the models that gather
  the mel before the ASR, or realign its content rows inside it;
- ``ParaPPGConstraintTask``: the amateur CE through the aligned ASR and
  ``ppg_constraint``, 0.1 x the masked MSE between the realigned amateur
  rows and the detached professional ones (both in the ASR's eval mode, as
  the JAX package calls ``train_vc_asr`` without ``train``);
- ``ParaPPGPretrainedTask``: the ASR loaded from ``pretrain_asr_ckpt`` (the
  port's ``VCPPGTask`` work dir or a JAX checkpoint) and frozen; its CE runs
  in validation only, without gradients;
- ``ParaPPGSpkConsistentTask``: the pretrained task with a second
  discriminator, ``'_spk'`` (``adv_base.py``), over the same fakes;
- ``AmtSpkTask``: the pretrained task whose every way takes its timbre from
  the amateur mel through the reference encoder, with no energy and no
  speaker embedding.
"""

from __future__ import annotations

import json
import os
from multiprocessing.pool import ThreadPool
from typing import Dict

import torch

from ..convert.jax2torch import vcppg_from_jax
from ..data.datasets import FastSingingF0AlignDataset, maybe_concat_dataset
from ..hparams import hparams
from ..models.svb_ppg import ParaAlignedPPG, ParaPPGConstraint, ParaPPGPreExp, ParaSVBPPG
from ..ops.fused_resblock import KERNEL_COUNTERS
from ..ops.pitch_utils import denorm_f0
from ..parallel import ddp
from ..utils.plot import spec_to_figure
from .adv_base import AdversarialTaskBase, cross_entropy_ignore0
from .losses import add_mel_loss

WAY_SRC = {"a2a": ("", ""), "p2p": ("prof_", "prof_"),
           "a2p": ("", "prof_"), "p2a": ("prof_", "")}


class SVBParaTask(AdversarialTaskBase):
    model_cls = ParaSVBPPG
    dataset_cls = FastSingingF0AlignDataset
    freeze_asr = False

    def __init__(self):
        super().__init__()
        ways = [w for w in hparams.get("concurrent_ways", "").split(",") if w]
        self.concurrent_ways = tuple(ways) or ("a2a", "p2p", "a2p")

    def build_generator(self, **over):
        hp = hparams
        kw = dict(
            hidden_size=hp["hidden_size"], num_mel_bins=hp["audio_num_mel_bins"],
            mel_strides=tuple(hp["mel_strides"]), asr_enc_layers=hp["asr_enc_layers"],
            asr_dec_layers=hp["asr_dec_layers"], asr_last_norm=hp["asr_last_norm"],
            ref_enc_out=hp["ref_enc_out"], use_energy=hp["use_energy"],
            use_spk_id=hp["use_spk_id"], num_spk=hp["num_spk"],
            use_tech=hp.get("use_tech", True), num_techs=hp.get("num_techs", 3),
            ref_attn=bool(hp.get("ref_attn")),
            asr_enc_type=hp.get("asr_enc_type") or "conformer",
            decoder_type=hp["decoder_type"], dec_layers=hp["dec_layers"],
            dec_ffn_kernel_size=hp.get("dec_ffn_kernel_size", 9), num_heads=hp.get("num_heads", 2),
            dropout=hp["dropout"])
        kw.update(over)
        return self.model_cls(self._dict_size(), **kw)

    def _from_jax(self, state: dict):
        return vcppg_from_jax(state["params"], state.get("batch_stats") or {})

    def build_model(self):
        """The generator; with ``freeze_asr`` its ASR comes from
        ``pretrain_asr_ckpt`` (JAX: svb_para.py:88-92)."""
        model = super().build_model()
        if self.freeze_asr:
            from .svb_vae_task import load_pretrained_asr
            load_pretrained_asr(model.vc_asr, hparams.get("pretrain_asr_ckpt") or "")
        return model

    def frozen_keys(self):
        return ("vc_asr",) if self.freeze_asr else ()

    # ------------------------------------------------------------------
    def prep_batch(self, batch, infer: bool = False):
        real = torch.get_default_dtype()
        b = {k: self._dev(batch[k], real)
             for k in ("mels", "prof_mels", "energy", "prof_energy")}
        for k in ("pitch", "prof_pitch", "a2p_f0_alignment", "p2a_f0_alignment",
                  "txt_tokens"):
            if batch.get(k) is not None:
                b[k] = self._dev(batch[k], torch.long)
        b["multi_spk_emb"] = (self._dev(batch["multi_spk_emb"], real)
                              if "multi_spk_emb" in batch else
                              torch.zeros(batch["mels"].shape[0], 1, 256, dtype=real,
                                          device=self.device))
        return b

    def _way_inputs(self, b, way):
        """(content mel, tech ids, alignment) of ``way``."""
        src, tgt = WAY_SRC[way]
        mels_content = b[f"{src}mels"]
        B = mels_content.shape[0]
        tech = torch.full((B,), int(tgt == "prof_"), dtype=torch.long, device=self.device)
        align = {"a2p": b.get("a2p_f0_alignment"),
                 "p2a": b.get("p2a_f0_alignment")}.get(way)
        return mels_content, tech, align

    def _one_way(self, b, way, generator):
        mels_content, tech, align = self._way_inputs(b, way)
        tgt = WAY_SRC[way][1]
        return self.model(mels_content, mels_content, b[f"{tgt}pitch"], b.get(f"{tgt}energy"),
                          b["multi_spk_emb"], tech, align, generator=generator)

    def forward_losses(self, b, generator, train: bool):
        losses: Dict[str, torch.Tensor] = {}
        fakes, gts = {}, {}
        for way in self.concurrent_ways:
            out = self._one_way(b, way, generator)
            mel_g = b[f"{WAY_SRC[way][1]}mels"]
            add_mel_loss(self.loss_and_lambda, out["mel_out"], mel_g, losses, postfix=way)
            fakes[f"{way}_"], gts[f"{way}_"] = out["mel_out"], mel_g
        self.add_asr_losses(b, losses, train)
        return losses, fakes, gts

    def add_asr_losses(self, b, losses, train: bool):
        """CE over the amateur and the professional mels (reference:
        svb_para.py:358-369)."""
        if "txt_tokens" not in b:
            return
        tokens = b["txt_tokens"]
        sides = {w[0] for w in self.concurrent_ways}
        for side, key in (("a", "mels"), ("p", "prof_mels")):
            if side in sides:
                losses[f"asr_{side}"] = cross_entropy_ignore0(
                    self.model.train_vc_asr(b[key], tokens), tokens)

    # ------------------------------------------------------------------
    def _f0s_and_lens(self, batch):
        def dev(k):
            return torch.as_tensor(batch[k], device=self.device)
        f0s = {"a2a": denorm_f0(dev("f0"), dev("uv"), hparams),
               "p2p": denorm_f0(dev("prof_f0"), dev("prof_uv"), hparams)}
        f0s["a2p"], f0s["p2a"] = f0s["p2p"], f0s["a2a"]
        lens = {"a2a": batch["mel_lengths"], "p2p": batch["prof_mel_lengths"]}
        lens["a2p"], lens["p2a"] = lens["p2p"], lens["a2a"]
        return f0s, lens

    def _get_vocoder(self):
        if self.vocoder is None:
            from ..vocoders.base import get_vocoder_cls
            self.vocoder = get_vocoder_cls(hparams)(dict(hparams), device=self.device)
        return self.vocoder

    def vis_validation(self, batch, fakes, gts, batch_idx):
        """Vocoded validation audio and the mel ``gt|pred`` figures of the
        first ``num_valid_plots`` batches every ``valid_infer_interval``
        steps (reference: svb_para.py:226-269). A batch without
        a professional side (the speech datasets') renders nothing: the JAX
        package reads its ``prof_f0`` there and raises KeyError."""
        if (self.logger is None or "prof_mels" not in batch
                or self.global_step % hparams["valid_infer_interval"] != 0
                or batch_idx >= hparams.get("num_valid_plots", 0)):
            return
        f0s, lens = self._f0s_and_lens(batch)
        for key, mel in fakes.items():
            way = key.rstrip("_")
            if way not in lens:
                continue
            L = int(lens[way][0])
            wav = self._get_vocoder().spec2wav(mel[0, :L], f0=f0s[way][0, :L])
            self.vocoder_calls += 1
            self.logger.add_audio(f"{way}_wavout_{batch_idx}", wav.cpu().numpy(),
                                  self.global_step, hparams["audio_sample_rate"])
            if self.logger.writes_figures:
                fig = spec_to_figure(torch.cat([gts[key][0, :L].float(), mel[0, :L].float()], -1),
                                     vmin=hparams["mel_vmin"], vmax=hparams["mel_vmax"],
                                     title=f"{way} gt|pred")
                self.logger.add_figure(f"{way}_gt_{batch_idx}", fig, self.global_step)

    # ------------------------------------------------------------------
    # inference (reference: svb_para.py:275-353)
    def test_start(self):
        self.saving_result_pool = ThreadPool(8)
        self.saving_results_futures = []
        self._get_vocoder()
        self.results_id = 0
        self.vocoder_calls = 0
        for c in KERNEL_COUNTERS:  # test_end reports the test loop's launches
            c.launches = 0

    @torch.no_grad()
    def test_step(self, batch, batch_idx: int):
        if batch["nsamples"] != 1:
            raise ValueError("inference supports batch_size=1")
        self.model.eval()
        b = self.prep_batch(batch, infer=True)
        f0s, lens = self._f0s_and_lens(batch)
        voc = self._get_vocoder()
        La, Lp = int(lens["a2a"][0]), int(lens["p2p"][0])
        wavs = {"gt_a_wavout": voc.spec2wav(b["mels"][0, :La], f0=f0s["a2a"][0, :La]),
                "gt_p_wavout": voc.spec2wav(b["prof_mels"][0, :Lp], f0=f0s["p2p"][0, :Lp])}
        for way in self.concurrent_ways:
            L = int(lens[way][0])
            mel = self._one_way(b, way, self.generator)["mel_out"][0, :L]
            wavs[f"{way}_wavout"] = voc.spec2wav(mel, f0=f0s[way][0, :L])
        self.vocoder_calls += len(wavs)
        gen_dir = os.path.join(hparams["work_dir"],
                               f"generated_{self.global_step}_{hparams['gen_dir_name']}")
        base_fn = f"[{self.results_id:06d}][{batch['item_name'][0]}][P]".replace(" ", "_")
        self.results_id += 1
        from .svb_vae_task import SVBVAEMleTask
        self.saving_results_futures.append(self.saving_result_pool.apply_async(
            SVBVAEMleTask.save_result,
            args=[{k: v.cpu().numpy() for k, v in wavs.items()}, base_fn, gen_dir, {}]))
        return {"item_name": batch["item_name"][0]}

    def test_end(self, outputs):
        self.saving_result_pool.close()
        for f in self.saving_results_futures:
            f.get()
        self.saving_result_pool.join()
        summary = {"device": str(self.device), "utts": self.results_id,
                   "vocoder_calls": self.vocoder_calls,
                   **{f"{c.__name__}_launches": c.launches for c in KERNEL_COUNTERS}}
        print(f"| infer summary: {json.dumps(summary)}")
        return summary

    # ------------------------------------------------------------------
    def train_dataloader(self):
        ds = maybe_concat_dataset(self.dataset_cls, hparams["train_set_name"], shuffle=True)
        return self.build_dataloader(ds, True, hparams["max_tokens"],
                                     hparams["max_sentences"],
                                     endless=hparams["endless_ds"], n_devices=self.n_devices)

    def val_dataloader(self):
        ds = self.dataset_cls(hparams["valid_set_name"], shuffle=False)
        max_vt, max_vs = hparams["max_valid_tokens"], hparams["max_valid_sentences"]
        return self.build_dataloader(ds, False, hparams["max_tokens"] if max_vt == -1 else max_vt,
                                     None if max_vs == -1 else max_vs)

    def test_dataloader(self):
        ds = self.dataset_cls(hparams["test_set_name"], shuffle=False)
        return self.build_dataloader(ds, max_sentences=1, use_batch_by_size=False)


class ParaPPGConstraintTask(SVBParaTask):
    """+ a PPG consistency constraint between the realigned amateur and the
    professional content rows (JAX: svb_para.py:290-321; reference:
    svb_para.py:371-407)."""
    model_cls = ParaPPGConstraint

    def add_asr_losses(self, b, losses, train: bool):
        if "txt_tokens" not in b:
            return
        tokens = b["txt_tokens"]
        logits_a, h_a = self.model.train_vc_asr(b["mels"], tokens, b["a2p_f0_alignment"],
                                                with_hidden=True)
        logits_p, h_p = self.model.train_vc_asr(b["prof_mels"], tokens, with_hidden=True)
        losses["asr_a"] = cross_entropy_ignore0(logits_a, tokens)
        losses["asr_p"] = cross_entropy_ignore0(logits_p, tokens)
        T = h_p.shape[1]
        scale = 1
        for s in hparams["mel_strides"]:
            scale *= int(s)
        mel_lengths = (b["prof_mels"].abs().sum(-1) > 0).sum(-1) // scale
        mask = (torch.arange(T, device=h_p.device)[None] < mel_lengths[:, None]).to(h_p.dtype)
        # the realigned rows' extra pooled frame (models/asr.py realign) drops off
        h_a = torch.nn.functional.pad(h_a[:, :T], (0, 0, 0, max(T - h_a.shape[1], 0)))
        diff = ((h_a - h_p.detach()) ** 2) * mask[:, :, None]
        losses["ppg_constraint"] = (ddp.all_sum(diff.sum())
                                    / (ddp.all_sum(mask.sum()) * h_p.shape[-1]).clamp_min(1.0)
                                    * 0.1)


class ParaPPGPreExpTask(SVBParaTask):
    model_cls = ParaPPGPreExp


class ParaAlignedPPGTask(SVBParaTask):
    model_cls = ParaAlignedPPG


class ParaPPGPretrainedTask(SVBParaTask):
    """The warm-started ASR, frozen; its CE is only watched, without
    gradients, in validation (JAX: svb_para.py:332-347; reference:
    svb_para.py:431-530)."""
    freeze_asr = True

    def add_asr_losses(self, b, losses, train: bool):
        if train or "txt_tokens" not in b:
            return
        tokens = b["txt_tokens"]
        with torch.no_grad():
            for name, key in (("asr_a", "mels"), ("asr_p", "prof_mels")):
                losses[name] = cross_entropy_ignore0(
                    self.model.train_vc_asr(b[key], tokens), tokens)


class ParaPPGSpkConsistentTask(ParaPPGPretrainedTask):
    """+ a second, speaker-consistency discriminator ``'_spk'`` over the
    generated mels (JAX: svb_para.py:350-366; reference: svb_para.py:533-631):
    with ``use_cond_disc`` off, the recipe's setting, it is a second
    unconditional multi-window mel discriminator."""

    def build_extra_discs(self):
        return {"_spk": self.new_disc}


class AmtSpkTask(ParaPPGPretrainedTask):
    """The amateur mel is the timbre of every way, through the reference
    encoder, with no energy and no speaker embedding (JAX:
    svb_para.py:369-390; reference: svb_para.py:632-687). The model's input
    projection is sized for the 256-wide speaker embedding and the energy
    embedding of the parallel task, so this path needs ``ref_enc_out: 256``
    and ``use_energy: false`` (the JAX task fails at its first step
    otherwise, a shape mismatch in ``encoded_embed_proj``)."""

    def __init__(self):
        super().__init__()
        if hparams["ref_enc_out"] != 256 or hparams["use_energy"] or hparams["use_spk_id"]:
            raise ValueError(
                "AmtSpkTask feeds the reference encoder's style and no energy into an "
                "input projection sized for the 256-wide speaker embedding and the "
                "energy embedding (neuralsvb_tpu/tasks/svb_para.py:369-390): set "
                "ref_enc_out: 256, use_energy: false and use_spk_id: false (got "
                f"{hparams['ref_enc_out']}, {hparams['use_energy']}, "
                f"{hparams['use_spk_id']})")

    def _one_way(self, b, way, generator):
        mels_content, tech, align = self._way_inputs(b, way)
        return self.model(mels_content, b["mels"], b[f"{WAY_SRC[way][1]}pitch"], None, None,
                          tech, align, generator=generator)
