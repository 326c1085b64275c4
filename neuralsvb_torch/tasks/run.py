"""CLI entry: ``python -m neuralsvb_torch.tasks.run --config <yaml>
--exp_name <name> --infer [--hparams "device=cpu,..."]``; port of
``neuralsvb_tpu/tasks/run.py`` (reference: tasks/run.py:5-15).

The ``device`` hparam picks where the model runs (``cuda`` in
``vae_global_mle_eng_torch.yaml``); asking for CUDA without a GPU raises.

Data-parallel training: ``torchrun --nproc_per_node N -m
neuralsvb_torch.tasks.run --config ... --hparams "mesh_shape=data:N"``
(``mesh_shape=''`` takes the launched world). Each process joins the world
before the task starts and leaves it at the end, as the JAX entry joins
its multi-host world under ``NSVB_MULTIHOST``; ``device=cuda`` becomes the
rank's ``cuda:LOCAL_RANK`` over NCCL, an explicit ``device=cuda:0`` puts
every rank on that card over gloo, and ``device=cpu`` takes gloo
(``parallel/ddp.py`` ``init_process_group``). Rank 0 alone writes
checkpoints, the config and the log (``training/trainer.py``).

``compute_dtype: bfloat16`` also sets ``torch.set_float32_matmul_precision
("medium")`` on the card, the nearest counterpart of the JAX entry's
``jax_default_matmul_precision=bfloat16``: float32 matmuls outside the bf16
apply may then use bf16 products. cuDNN's float32 convolutions stay off
TF32.
"""

import importlib
import os
import shutil
import sys
import time

import torch

from ..hparams import hparams, set_hparams
from ..parallel import ddp


def line_buffer_launched_stdout() -> None:
    """Under torchrun the ranks write into one shared stdout pipe. torchrun
    starts them with ``python -u``, which writes each piece of a ``print``
    (the text, then its newline) through at once, and a block-buffered pipe
    may flush mid-line: either way another rank's output can land inside a
    line. Line-buffered without write-through, each line of up to PIPE_BUF
    (4 KB) reaches the pipe in one atomic ``write``."""
    if ddp.launched():
        sys.stdout.reconfigure(line_buffering=True, write_through=False)


def save_codes() -> None:
    """``save_codes``: a snapshot of the listed directories under
    ``work_dir/codes/<timestamp>/``, on rank 0 only (JAX:
    ``neuralsvb_tpu/tasks/run.py:15-27``; reference: base_task.py:342-349)."""
    dirs = hparams.get("save_codes") or []
    if not dirs or not hparams.get("work_dir") or not ddp.is_main():
        return
    dst_root = os.path.join(hparams["work_dir"], "codes", time.strftime("%Y%m%d%H%M%S"))
    for d in dirs:
        if os.path.isdir(d):
            shutil.copytree(d, os.path.join(dst_root, os.path.basename(d)),
                            ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    print(f"| Saved codes to {dst_root}")


def run_task():
    if not hparams.get("task_cls"):
        raise ValueError("config must define task_cls")
    # float32 throughout: cuDNN would otherwise run float32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = str(hparams.get("device") or "")
    rank_device = ddp.init_process_group(device) if device else None
    if rank_device is not None:
        device = hparams["device"] = str(rank_device)
        print(f"| data parallel: rank {ddp.rank()}/{ddp.world_size()} on {device} "
              f"({torch.distributed.get_backend()})")
    if hparams.get("compute_dtype") == "bfloat16" and device.startswith("cuda"):
        torch.set_float32_matmul_precision("medium")
    if not hparams.get("infer"):
        save_codes()
    pkg, cls_name = hparams["task_cls"].rsplit(".", 1)
    task_cls = getattr(importlib.import_module(pkg), cls_name)
    try:
        return task_cls.start()
    finally:
        ddp.destroy_process_group()


def main():
    line_buffer_launched_stdout()
    set_hparams()
    run_task()


if __name__ == "__main__":
    main()
