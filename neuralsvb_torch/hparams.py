"""Config/flag system (layer L0); port of ``neuralsvb_tpu/hparams.py``.

Behavioral parity with the reference CLI contract (reference: utils/hparams.py:17-128):

- YAML files form a DAG through ``base_config`` entries (string or list);
  relative paths (leading '.') resolve against the including file. Configs are
  deep-merged depth-first with a visited-set cycle guard.
- ``--exp_name E`` binds ``work_dir = checkpoints/E``; a previously saved
  ``checkpoints/E/config.yaml`` overlays the freshly merged config unless
  ``--reset`` is given; on (re)launch the merged config is persisted back
  (not when ``--infer``).
- ``--hparams "a=1,b.c=2,d=[1 1 1]"`` applies dotted typed overrides.
- ``infer/validate/debug/exp_name`` are injected into the dict.

Unlike the reference we avoid ``eval`` for override values (safe literal
parsing) but accept the same syntax.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import os
import shutil
from typing import Any, Dict, Optional

import torch
import yaml

# Module-global hparams dict, read ambiently by tasks/models (reference pattern).
hparams: Dict[str, Any] = {}

_printed_once = False


@contextlib.contextmanager
def hparams_scope(new: Optional[Dict[str, Any]] = None, **overrides):
    """Scoped view of the global ``hparams`` dict: snapshot on entry,
    restore on exit (exception-safe, reentrant). ``new`` replaces the whole
    dict for the scope; keyword ``overrides`` are applied on top."""
    saved = copy.deepcopy(hparams)
    try:
        if new is not None:
            hparams.clear()
            hparams.update(new)
        hparams.update(overrides)
        yield hparams
    finally:
        hparams.clear()
        hparams.update(saved)


def override_config(old_config: dict, new_config: dict) -> None:
    """Deep-merge ``new_config`` into ``old_config`` (dicts merged recursively)."""
    for k, v in new_config.items():
        if isinstance(v, dict) and isinstance(old_config.get(k), dict):
            override_config(old_config[k], v)
        else:
            old_config[k] = v


def _parse_override_value(raw: str, current: Any) -> Any:
    """Parse an override value string with the reference's coercion rules."""
    raw = raw.strip("'\" ")
    if raw in ("True", "False"):
        return raw == "True"
    if isinstance(current, bool):
        return raw.lower() in ("true", "1", "yes")
    if isinstance(current, (list, dict)) or (raw[:1] in "[{(" if raw else False):
        txt = raw.replace(" ", ",") if isinstance(current, list) else raw
        return ast.literal_eval(txt)
    if current is None:
        # Best-effort literal parse, falling back to string.
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return raw
    if isinstance(current, int) and not isinstance(current, bool):
        # int-typed default must still accept a float override
        # (e.g. clip_grad_value: 0 -> --hparams "clip_grad_value=0.5")
        try:
            return int(raw)
        except ValueError:
            return float(raw)
    return type(current)(raw)


def apply_overrides(config: dict, hparams_str: str) -> None:
    """Apply ``--hparams "a=1,b.c=2"`` style dotted overrides in place."""
    if not hparams_str:
        return
    for item in hparams_str.split(","):
        if "=" not in item:
            continue
        key, value = item.split("=", 1)
        node = config
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf = parts[-1]
        node[leaf] = _parse_override_value(value, node.get(leaf))


def load_config_recursive(config_fn: str, _visited=None, _chains=None) -> dict:
    """Depth-first merge of the ``base_config`` DAG rooted at ``config_fn``."""
    if _visited is None:
        _visited = set()
    if _chains is None:
        _chains = []
    if not os.path.exists(config_fn):
        return {}
    with open(config_fn) as f:
        this_cfg = yaml.safe_load(f) or {}
    _visited.add(config_fn)
    merged: dict = {}
    bases = this_cfg.get("base_config", [])
    if not isinstance(bases, list):
        bases = [bases]
    for base in bases:
        if base.startswith("."):
            base = os.path.normpath(os.path.join(os.path.dirname(config_fn), base))
        if base not in _visited:
            override_config(merged, load_config_recursive(base, _visited, _chains))
    override_config(merged, this_cfg)
    _chains.append(config_fn)
    return merged


def resolve_device(name) -> torch.device:
    """The ``device`` hparam -> torch.device. It must be set: a missing
    device, or CUDA without a GPU, raises rather than running elsewhere."""
    if not name:
        raise ValueError("the device is not set: give the 'device' hparam "
                         "(cuda or cpu), e.g. --hparams device=cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} but torch.cuda.is_available() is "
                           "False; pass --hparams device=cpu to run on the CPU")
    return dev


class Args:
    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)


def set_hparams(config: str = "", exp_name: str = "", hparams_str: str = "",
                print_hparams: bool = True, global_hparams: bool = True) -> dict:
    """Build the merged hparams dict; CLI-compatible with the reference.

    When called with no ``config``/``exp_name``, parses argv
    (``--config --exp_name --hparams --infer --validate --reset --remove --debug``).
    """
    if config == "" and exp_name == "":
        parser = argparse.ArgumentParser(description="neuralsvb_torch")
        parser.add_argument("--config", type=str, default="")
        parser.add_argument("--exp_name", type=str, default="")
        parser.add_argument("--hparams", type=str, default="")
        parser.add_argument("--infer", action="store_true")
        parser.add_argument("--validate", action="store_true")
        parser.add_argument("--reset", action="store_true")
        parser.add_argument("--remove", action="store_true")
        parser.add_argument("--debug", action="store_true")
        args, _unknown = parser.parse_known_args()
    else:
        args = Args(config=config, exp_name=exp_name, hparams=hparams_str,
                    infer=False, validate=False, reset=False, remove=False, debug=False)
    assert args.config != "" or args.exp_name != "", "need --config or --exp_name"

    chains: list = []
    merged: dict = {}
    if args.config:
        merged = load_config_recursive(args.config, _chains=chains)

    work_dir = ""
    ckpt_config_path = ""
    if args.exp_name:
        work_dir = f"checkpoints/{args.exp_name}"
        ckpt_config_path = f"{work_dir}/config.yaml"
        if os.path.exists(ckpt_config_path) and not args.reset:
            with open(ckpt_config_path) as f:
                saved = yaml.safe_load(f)
            if saved:
                merged.update(saved)
    merged["work_dir"] = work_dir

    apply_overrides(merged, args.hparams)

    if work_dir and args.remove and os.path.exists(work_dir):
        shutil.rmtree(work_dir)
    if work_dir and (not os.path.exists(ckpt_config_path) or args.reset) and not args.infer:
        os.makedirs(work_dir, exist_ok=True)
        with open(ckpt_config_path, "w") as f:
            yaml.safe_dump(merged, f)

    merged["infer"] = args.infer
    merged["debug"] = args.debug
    merged["validate"] = args.validate
    merged["exp_name"] = args.exp_name

    global _printed_once
    if global_hparams:
        hparams.clear()
        hparams.update(merged)
    # Under torchrun every rank shares one stdout pipe, and a pipe write over
    # PIPE_BUF (4 KB) is not atomic: the long dump comes from rank 0 alone.
    # The world is not joined yet, so the rank is torchrun's environment's.
    if (print_hparams and global_hparams and not _printed_once
            and int(os.environ.get("RANK", 0)) == 0):
        print("| Hparams chains:", chains)
        print("| Hparams:", {k: merged[k] for k in sorted(merged)})
        _printed_once = True
    return merged
