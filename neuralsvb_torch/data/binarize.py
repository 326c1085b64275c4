"""Binarize CLI: ``python -m neuralsvb_torch.data.binarize --config <yaml>
[--hparams "device=cpu,..."]``; port of ``neuralsvb_tpu/data/binarize.py``
(reference: data_gen/tts/bin/binarize.py:9-20).

The flagship's data is made in two passes, speaker embeddings first:
``egs/datasets/audio/PopBuTFy/save_emb_torch.yaml`` (``SaveSpkEmb``), then
``para_bin_torch.yaml`` (``PopBuTFyENSpkEMBinarizer``). The ``device``
hparam picks where the mel, pitch, DTW-cost and GE2E work runs.
"""

import importlib

import torch

from ..hparams import hparams, set_hparams


def binarize():
    # float32 throughout: cuDNN would otherwise run the GE2E LSTM in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg, cls_name = hparams["binarizer_cls"].rsplit(".", 1)
    cls = getattr(importlib.import_module(pkg), cls_name)
    print("| Binarizer:", cls)
    cls().process()


def main():
    set_hparams()
    binarize()


if __name__ == "__main__":
    main()
