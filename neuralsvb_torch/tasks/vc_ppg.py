"""ASR pre-training: the speech voice-conversion task over ``VCPPG``; port
of ``neuralsvb_tpu/tasks/vc_ppg.py`` (reference: tasks/vc/vc_ppg.py:21-156),
the ``egs/egs_bases/vc/vc_ppg_torch.yaml`` recipe.

Each generator step reconstructs the mel from its pitch, energy, the
ASR's PPG (without gradients) and the reference encoder's style vector
(``l1``, ``ssim``), adds the ASR's CE loss over the phone tokens (``asr``;
the only loss that trains the ASR, in eval mode at exact lengths, as in the
JAX package) and, once on, the adversarial term (``a``); the discriminator
step logs ``r`` and ``f``. The flagship's ``pretrain_asr_ckpt`` reads this
task's checkpoints: their ``vc_asr.*`` keys are the frozen PPG extractor's.

``--infer`` raises: the JAX package's ``test_step`` reads
``multi_spk_emb`` (``svb_para.py:136,220``), which ``VCPPGTask.prep_batch``
never sets (``vc_ppg.py:89-103``), so it offers no result to match. Its
loose-wav test inputs (``load_test_inputs``, ``RawWavDataset``) wait with it.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..data.datasets import FastSpeechDataset
from ..hparams import hparams
from ..models.svb_ppg import VCPPG
from .adv_base import cross_entropy_ignore0
from .losses import add_mel_loss
from .svb_para import SVBParaTask


class VCPPGTask(SVBParaTask):
    model_cls = VCPPG
    dataset_cls = FastSpeechDataset

    def build_generator(self):
        return super().build_generator(use_tech=False)  # VCPPG takes no technique

    def prep_batch(self, batch, infer: bool = False):
        real = torch.get_default_dtype()
        b = {"mels": self._dev(batch["mels"], real),
             "pitch": self._dev(batch["pitch"], torch.long),
             "energy": self._dev(batch["energy"], real)}
        if hparams["use_spk_id"] and batch.get("spk_ids") is not None:
            b["spk_ids"] = self._dev(batch["spk_ids"], torch.long)
        if batch.get("txt_tokens") is not None:
            b["txt_tokens"] = self._dev(batch["txt_tokens"], torch.long)
        return b

    def forward_losses(self, b, generator, train: bool):
        losses: Dict[str, torch.Tensor] = {}
        out = self.model(b["mels"], b["mels"], b["pitch"], b["energy"], b.get("spk_ids"),
                         None, None, generator=generator)
        add_mel_loss(self.loss_and_lambda, out["mel_out"], b["mels"], losses)
        if "txt_tokens" in b:
            losses["asr"] = cross_entropy_ignore0(
                self.model.train_vc_asr(b["mels"], b["txt_tokens"]), b["txt_tokens"])
        return losses, {"": out["mel_out"]}, {"": b["mels"]}

    def test_step(self, batch, batch_idx: int):
        raise NotImplementedError(
            "VCPPGTask --infer: the JAX package's test_step reads batch['multi_spk_emb'] "
            "(neuralsvb_tpu/tasks/svb_para.py:136,220), which VCPPGTask.prep_batch never "
            "sets (neuralsvb_tpu/tasks/vc_ppg.py:89-103), so it raises KeyError and offers "
            "no result to match (ROADMAP.md)")
