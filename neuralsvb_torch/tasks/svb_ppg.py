"""The non-parallel SVB task; port of ``neuralsvb_tpu/tasks/svb_ppg.py``
(reference: tasks/singing/svb_ppg.py:22-203): ``SVBPPG`` trained on one
side of a singing batch per step, amateur or professional at random (the
technique id says which), with the mel losses and the ASR's CE loss
(``asr``). The side comes from the task's seeded numpy stream, which the
checkpoints carry, so a resumed run draws what the uninterrupted run draws.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.datasets import FastSingingDataset
from ..hparams import hparams
from ..models.svb_ppg import SVBPPG
from .adv_base import cross_entropy_ignore0
from .losses import add_mel_loss
from .svb_para import SVBParaTask


class SVBPPGTask(SVBParaTask):
    model_cls = SVBPPG
    dataset_cls = FastSingingDataset

    def prep_batch(self, batch, infer: bool = False):
        # a random technique prefix per training step (reference: svb_ppg.py:40)
        prefix = "" if infer else ["", "prof_"][self._np_rng.randint(0, 2)]
        real = torch.get_default_dtype()
        b = {"mels": self._dev(batch[f"{prefix}mels"], real),
             "pitch": self._dev(batch[f"{prefix}pitch"], torch.long),
             "energy": self._dev(batch[f"{prefix}energy"], real),
             "tech": self._dev(np.full(batch["mels"].shape[0], int(prefix == "prof_")),
                               torch.long)}
        if hparams["use_spk_id"] and batch.get("spk_ids") is not None:
            b["spk_ids"] = self._dev(batch["spk_ids"], torch.long)
        if batch.get("txt_tokens") is not None:
            b["txt_tokens"] = self._dev(batch["txt_tokens"], torch.long)
        return b

    def forward_losses(self, b, generator, train: bool):
        losses: Dict[str, torch.Tensor] = {}
        out = self.model(b["mels"], b["mels"], b["pitch"], b["energy"], b.get("spk_ids"),
                         b.get("tech"), None, generator=generator)
        add_mel_loss(self.loss_and_lambda, out["mel_out"], b["mels"], losses)
        if "txt_tokens" in b:
            losses["asr"] = cross_entropy_ignore0(
                self.model.train_vc_asr(b["mels"], b["txt_tokens"]), b["txt_tokens"])
        return losses, {"": out["mel_out"]}, {"": b["mels"]}
