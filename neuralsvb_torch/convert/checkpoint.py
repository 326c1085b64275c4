"""Reading checkpoints into the port's modules.

A PyTorch checkpoint is a ``torch.save`` file in the reference's layout:
``{"state_dict": {<key>: module state_dict}}`` with ``<key>`` ``model`` (the
SVB VAE) or ``model_gen`` (a vocoder's generator), under the reference's
parameter names, possibly weight-normed. A checkpoint of the JAX package
(``neuralsvb_tpu/training/checkpoint.py``: msgpack ``{epoch, global_step,
checkpoint_callback_best, state}``) is decoded by ``msgpack_ckpt`` and
mapped by the matching ``jax2torch`` function of its ``state``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Callable, Dict, Optional

import torch

from . import msgpack_ckpt

FromJax = Callable[[dict], Dict[str, torch.Tensor]]


def newest_checkpoint(directory: str) -> Optional[str]:
    """The ``model_ckpt_steps_*.ckpt`` with the highest step, or None."""
    ckpts = glob.glob(os.path.join(directory, "model_ckpt_steps_*.ckpt"))
    if not ckpts:
        return None
    return max(ckpts, key=lambda p: int(re.findall(r"steps_(\d+)\.ckpt", p)[0]))


def is_torch_file(path: str) -> bool:
    # torch saves zip archives (PK..) or legacy pickles (\x80); the JAX
    # package writes msgpack
    with open(path, "rb") as f:
        head = f.read(4)
    return head == b"PK\x03\x04" or head[:1] == b"\x80"


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold ``weight_g``/``weight_v`` pairs into plain ``weight`` entries."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            g, v = sd[base + "weight_g"], sd[k]
            norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[base + "weight"] = g * v / norm.clamp_min(1e-12)
            del out[k], out[base + "weight_g"]
    return out


def load_jax_state(path: str) -> dict:
    """The ``state`` tree of a JAX package checkpoint (numpy leaves)."""
    raw = msgpack_ckpt.load(path)
    if not isinstance(raw, dict) or not isinstance(raw.get("state"), dict):
        raise ValueError(f"{path}: not a neuralsvb_tpu checkpoint (no 'state' map)")
    return raw["state"]


def load_state_dict(path: str, key: str,
                    from_jax: Optional[FromJax] = None) -> Dict[str, torch.Tensor]:
    """Checkpoint file -> the flat {name: tensor} of ``state_dict[key]`` on
    the CPU, weight norm folded. A JAX package checkpoint is read when
    ``from_jax`` is given: it maps the checkpoint's ``state`` tree to the
    port's names (e.g. ``lambda st: hifigan_from_jax(st["params"])``)."""
    if not is_torch_file(path):
        if from_jax is None:
            raise ValueError(
                f"{path} is not a PyTorch checkpoint (a JAX msgpack checkpoint of "
                "neuralsvb_tpu?) and no jax2torch map was given to read it")
        return from_jax(load_jax_state(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    try:
        sd = state["state_dict"][key]
    except (KeyError, TypeError):
        raise KeyError(f"{path}: no state_dict[{key!r}] in the checkpoint") from None
    return fold_weight_norm(dict(sd))


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str):
    """Load ``sd`` into ``module``; every module key must be present, keys
    the port does not have (e.g. the ASR decoder) are reported and skipped."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{what}: checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    extra = [k for k in sd if k not in own]
    if extra:
        print(f"| {what}: ignoring {len(extra)} checkpoint keys the port does "
              f"not use, e.g. {extra[:3]}")
    module.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)
