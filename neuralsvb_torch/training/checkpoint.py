"""Training checkpoints in the reference's PyTorch layout with the JAX
package's retention semantics; port of ``neuralsvb_tpu/training/checkpoint.py``
(reference: utils/trainer.py:347-436, utils/ckpt_utils.py:8-69).

One ``torch.save`` file per save, ``model_ckpt_steps_{N}.ckpt``, holding
``state_dict`` (``model``, ``mel_disc``), ``optimizer_states``,
``global_step``, ``epoch`` and ``checkpoint_callback_best``; every value is a
tensor or a Python primitive, so ``torch.load(weights_only=True)`` reads it.
Written atomically (``.part`` + ``os.replace``); the newest
``num_ckpt_keep`` are kept.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import List, Optional

import torch

from ..convert.checkpoint import is_torch_file


def get_all_ckpts(work_dir: str, steps: Optional[int] = None) -> List[str]:
    """The step checkpoints of ``work_dir``, newest first."""
    pattern = f"model_ckpt_steps_{steps if steps is not None else '*'}.ckpt"
    return sorted(glob.glob(os.path.join(work_dir, pattern)),
                  key=lambda p: -int(re.findall(r"steps_(\d+)\.ckpt$", p)[0]))


def get_last_checkpoint(work_dir: str, steps: Optional[int] = None) -> Optional[str]:
    ckpts = get_all_ckpts(work_dir, steps)
    return ckpts[0] if ckpts else None


def save_checkpoint(payload: dict, work_dir: str, global_step: int,
                    num_ckpt_keep: int = 3, is_best: bool = False) -> str:
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"model_ckpt_steps_{global_step}.ckpt")
    torch.save(payload, path + ".part")
    os.replace(path + ".part", path)
    for old in get_all_ckpts(work_dir)[num_ckpt_keep:]:
        os.remove(old)
        print(f"| Delete ckpt: {os.path.basename(old)}")
    if is_best:
        best = os.path.join(work_dir, "model_ckpt_best.pt")
        shutil.copyfile(path, best + ".part")
        os.replace(best + ".part", best)
    return path


def load_checkpoint(path: str) -> dict:
    """A checkpoint of the port's own to resume from. A JAX package
    checkpoint holds no PyTorch optimizer state and is refused here; warm
    start from it with ``load_ckpt`` (or serve it) instead."""
    if not is_torch_file(path):
        raise ValueError(f"{path} is not a checkpoint of the port (a JAX msgpack "
                         "checkpoint?): resume reads only the port's own; pass a JAX "
                         "checkpoint as load_ckpt, from a work_dir without checkpoints")
    return torch.load(path, map_location="cpu", weights_only=True)
