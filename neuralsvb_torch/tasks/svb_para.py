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

Its six subclasses (PPG constraint, pre-expansion, aligned ASR, frozen
pretrained ASR, speaker consistency, amateur speaker;
``svb_para.py:290-390`` in the JAX package) are not ported (ROADMAP.md).
"""

from __future__ import annotations

import os
from multiprocessing.pool import ThreadPool
from typing import Dict

import torch

from ..convert.jax2torch import vcppg_from_jax
from ..data.datasets import FastSingingF0AlignDataset, maybe_concat_dataset
from ..hparams import hparams
from ..models.svb_ppg import ParaSVBPPG
from ..ops.pitch_utils import denorm_f0
from .adv_base import AdversarialTaskBase, cross_entropy_ignore0
from .losses import add_mel_loss

WAY_SRC = {"a2a": ("", ""), "p2p": ("prof_", "prof_"),
           "a2p": ("", "prof_"), "p2a": ("prof_", "")}


class SVBParaTask(AdversarialTaskBase):
    model_cls = ParaSVBPPG
    dataset_cls = FastSingingF0AlignDataset

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

    def _one_way(self, b, way, generator):
        src, tgt = WAY_SRC[way]
        mels_content = b[f"{src}mels"]
        B = mels_content.shape[0]
        tech = torch.full((B,), int(tgt == "prof_"), dtype=torch.long, device=self.device)
        align = {"a2p": b.get("a2p_f0_alignment"),
                 "p2a": b.get("p2a_f0_alignment")}.get(way)
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
        self.add_asr_losses(b, losses)
        return losses, fakes, gts

    def add_asr_losses(self, b, losses):
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
        """Vocoded validation audio of the first ``num_valid_plots`` batches
        every ``valid_infer_interval`` steps (reference:
        svb_para.py:226-269; the mel figures are not drawn). A batch without
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

    # ------------------------------------------------------------------
    # inference (reference: svb_para.py:275-353)
    def test_start(self):
        self.saving_result_pool = ThreadPool(8)
        self.saving_results_futures = []
        self._get_vocoder()
        self.results_id = 0

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
        return {}

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
