"""The ResBlock-cluster op of the PyTorch port vs the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX oracle ``resblock_cluster_reference`` and against the
Pallas kernel ``fused_resblock_cluster`` (f32 operands, interpret mode) at
1e-4, and its autograd path against ``jax.grad`` at 2e-3 (the tolerances of
tests/test_fused_resblock.py). The CUDA kernel itself is compared with the
plain version on the card by ``test_kernel_matches_plain_on_card`` (marked
``cuda``) and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree, sd_numpy, seeded  # noqa: E402

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.ops.fused_resblock import (fused_resblock_cluster as  # noqa: E402
                                              jax_fused, resblock_cluster_reference)
from neuralsvb_torch.models.hifigan import ResBlock1  # noqa: E402
from neuralsvb_torch.ops import fused_resblock as fr  # noqa: E402

KS = (3, 7, 11)
DILS = ((1, 3, 5),) * 3
SPEC = fr.make_spec(KS, DILS)


def _towers(C, seed=0):
    return [seeded(lambda k=k: ResBlock1(C, k, (1, 3, 5)), seed + r)
            for r, k in enumerate(KS)]


def _jax_params(towers):
    out = []
    for tm in towers:
        sd = sd_numpy(tm)
        out.append({f"conv{n}_{j}": t2j._conv(sd, f"convs{n}.{j}")
                    for n in (1, 2) for j in range(3)})
    return out


def _packed(towers):
    return [w for tm in towers for w in fr.pack_tower(tm.convs1, tm.convs2)]


@pytest.mark.parametrize("B,C,T", [(1, 64, 300), (1, 128, 256), (1, 64, 515),
                                   (3, 64, 260)])
def test_plain_cluster_matches_jax(B, C, T):
    towers = _towers(C)
    x = np.random.RandomState(1).randn(B, T, C).astype(np.float32)
    with torch.no_grad():
        y = fr.fused_resblock_cluster(torch.tensor(x).transpose(1, 2).contiguous(),
                                      _packed(towers), SPEC).transpose(1, 2)
    params = _jax_params(towers)
    agree(y, resblock_cluster_reference(jnp.asarray(x), params, KS, DILS), 1e-4,
          "vs JAX reference")
    agree(y, jax_fused(jnp.asarray(x), params, KS, DILS, Tt=128,
                       mm_dtype=jnp.float32), 1e-4, "vs JAX Pallas kernel")


def test_plain_cluster_equals_resblock_modules():
    """The cluster op is the mean of the generator's ResBlock1 modules."""
    towers = _towers(32)
    x = torch.randn(2, 32, 100, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = sum(tm(x) for tm in towers) / 3
        y = fr.fused_resblock_cluster(x, _packed(towers), SPEC)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)


def test_autograd_matches_jax_grad():
    C, T = 64, 260
    towers = _towers(C)
    x = np.random.RandomState(2).randn(1, T, C).astype(np.float32)
    xt = torch.tensor(x).transpose(1, 2).contiguous().requires_grad_(True)
    y = fr.fused_resblock_cluster(xt, _packed(towers), SPEC)
    (y ** 2).sum().backward()

    params = tuple(_jax_params(towers))
    gx, gp = jax.grad(
        lambda x_, p_: jnp.sum(resblock_cluster_reference(x_, p_, KS, DILS) ** 2),
        argnums=(0, 1))(jnp.asarray(x), params)
    agree(xt.grad.transpose(1, 2), gx, 2e-3, "dL/dx")
    for r, tm in enumerate(towers):
        for n, convs in ((1, tm.convs1), (2, tm.convs2)):
            for j, conv in enumerate(convs):
                g = gp[r][f"conv{n}_{j}"]
                agree(conv.weight.grad.permute(2, 1, 0), g["kernel"], 2e-3,
                      f"dL/dW tower {r} conv{n}_{j}")
                agree(conv.bias.grad, g["bias"], 2e-3, f"dL/db tower {r} conv{n}_{j}")


def test_cpu_wrapper_refuses_other_dtypes():
    x = torch.zeros(1, 32, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        fr.fused_resblock_cluster(x, _packed(_towers(32)), SPEC)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel vs the plain version at a flagship stage shape, TF32
    off (cuDNN would otherwise round the plain version's convs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    towers = [t.cuda() for t in _towers(128)]
    x = torch.randn(2, 128, 4000, device="cuda")
    with torch.no_grad():
        w = _packed(towers)
        before = fr.resblock_conv1d.launches
        y = fr.fused_resblock_cluster(x, w, SPEC)
        ref = fr.resblock_cluster_plain(x, w, SPEC)
    torch.cuda.synchronize()
    assert fr.resblock_conv1d.launches - before == 18
    assert float((y - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
