"""Reading reference-format PyTorch checkpoints into the port's modules.

A checkpoint is a ``torch.save`` file in the reference's layout:
``{"state_dict": {<key>: module state_dict}}`` with ``<key>`` ``model`` (the
SVB VAE) or ``model_gen`` (the HiFiGAN generator), under the reference's
parameter names, possibly weight-normed. The JAX package's own msgpack
checkpoints need flax to read and are refused with a clear error.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import torch


def newest_checkpoint(directory: str) -> Optional[str]:
    """The ``model_ckpt_steps_*.ckpt`` with the highest step, or None."""
    ckpts = glob.glob(os.path.join(directory, "model_ckpt_steps_*.ckpt"))
    if not ckpts:
        return None
    return max(ckpts, key=lambda p: int(re.findall(r"steps_(\d+)\.ckpt", p)[0]))


def _is_torch_file(path: str) -> bool:
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


def load_state_dict(path: str, key: str) -> Dict[str, torch.Tensor]:
    """Checkpoint file -> the flat {name: tensor} of ``state_dict[key]`` on
    the CPU, weight norm folded."""
    if not _is_torch_file(path):
        raise ValueError(
            f"{path} is not a PyTorch checkpoint (a JAX msgpack checkpoint of "
            "neuralsvb_tpu?). Reading those needs flax and is not ported yet "
            "(ROADMAP.md); convert with neuralsvb_torch.convert.jax2torch.")
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
