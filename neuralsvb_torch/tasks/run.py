"""CLI entry: ``python -m neuralsvb_torch.tasks.run --config <yaml>
--exp_name <name> --infer [--hparams "device=cpu,..."]``; port of
``neuralsvb_tpu/tasks/run.py`` (reference: tasks/run.py:5-15).

The ``device`` hparam picks where the model runs (``cuda`` in
``vae_global_mle_eng_torch.yaml``); asking for CUDA without a GPU raises.
"""

import importlib

import torch

from ..hparams import hparams, set_hparams


def run_task():
    if not hparams.get("task_cls"):
        raise ValueError("config must define task_cls")
    # float32 throughout: cuDNN would otherwise run float32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg, cls_name = hparams["task_cls"].rsplit(".", 1)
    task_cls = getattr(importlib.import_module(pkg), cls_name)
    return task_cls.start()


def main():
    set_hparams()
    run_task()


if __name__ == "__main__":
    main()
