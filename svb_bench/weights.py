"""Weights made by the benchmark from the seed, on the device, in one draw.

Every cell's modules take these weights, and the reference takes the same
ones: ``seeded_state`` lays one standard-normal draw of a ``torch.Generator``
on the device over the parameters of a module, leaf by leaf in name order,
each scaled to a fan-in initialisation. Buffers (BatchNorm statistics) keep
their construction values, which both sides share."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

Spec = List[Tuple[str, Tuple[int, ...], float, float]]  # name, shape, std, mean

NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)


def init_spec(module: nn.Module) -> Spec:
    """(name, shape, std, mean) of every parameter of ``module``, sorted by
    name: convolutions and linear maps N(0, 1/fan_in), a transposed
    convolution's fan-in counted per output sample, norm scales N(1, 0.05^2),
    biases N(0, 0.02^2), other matrices N(0, 1/last dim)."""
    spec = []
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            std, mean = 0.02, 0.0
            if isinstance(m, NORMS):
                std, mean = (0.05, 1.0) if pname == "weight" else (0.02, 0.0)
            elif pname == "bias":
                std = 0.02
            elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
                k, s = math.prod(m.kernel_size), math.prod(m.stride)
                std = 1.0 / math.sqrt(shape[0] * k / s / m.groups)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                std = 1.0 / math.sqrt(math.prod(shape[1:]))
            elif len(shape) >= 2:
                std = 1.0 / math.sqrt(shape[-1])
            spec.append((name, shape, std, mean))
    return sorted(spec)


def seeded_state(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters of ``spec`` from one float32 draw of a generator on
    ``device`` seeded by ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape, std, mean in spec:
        n = math.prod(shape)
        out[name] = flat[i:i + n].view(shape).mul_(std).add_(mean)
        i += n
    return out


def load_seeded(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copies ``state`` into ``module``'s parameters; every parameter must
    be there and every entry must be a parameter of ``module``."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        missing = sorted(set(params) - set(state))[:5]
        extra = sorted(set(state) - set(params))[:5]
        raise ValueError(f"seeded weights do not fit: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state[name])
