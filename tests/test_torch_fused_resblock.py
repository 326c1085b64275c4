"""The ResBlock-cluster op of the PyTorch port vs the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX oracle ``resblock_cluster_reference`` and against the
Pallas kernel ``fused_resblock_cluster`` (f32 operands, interpret mode) at
1e-4, and its autograd path against ``jax.grad`` at 2e-3 (the tolerances of
tests/test_fused_resblock.py). With bf16 operands (``mm_dtype``) the plain
version is held against the Pallas kernel with ``mm_dtype=bf16`` and its
packed weights against the JAX packing, bit for bit. The backward's plain
twin (the decomposition the CUDA backward kernels compute) is held against
autograd through the plain version in float64 and float32. The CUDA kernels
themselves are compared with the plain version on the card by the tests
marked ``cuda`` and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree, sd_numpy, seeded  # noqa: E402

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.ops.fused_resblock import (_pack_tower,  # noqa: E402
                                              fused_resblock_cluster as jax_fused,
                                              resblock_cluster_reference)
from neuralsvb_torch.models.hifigan import HifiGanGenerator, ResBlock1  # noqa: E402
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


def _packed(towers, mm_dtype=torch.float32):
    return [w for tm in towers for w in fr.pack_tower(tm.convs1, tm.convs2, mm_dtype)]


SHAPES = [(1, 64, 300), (1, 128, 256), (1, 64, 515), (3, 64, 260)]


@pytest.mark.parametrize("B,C,T", SHAPES)
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


@pytest.mark.parametrize("B,C,T", SHAPES)
def test_plain_bf16_matches_jax_pallas_bf16(B, C, T):
    """bf16 operands: the port's plain version against the Pallas kernel
    with ``mm_dtype=bf16`` (interpret mode) within 3e-4 * max(1, max|ref|).
    Both round the same operands to bf16, but where the two f32 sums land on
    opposite sides of a bf16 rounding edge the next conv's operand flips by
    one bf16 step; at these shapes that leaves at most 1.2e-4 of max|ref|.
    f32 operands differ from the bf16 kernel by about 6e-4 of max|ref|, so
    the bound tells bf16 from f32 (the f32 plain version must fail it)."""
    towers = _towers(C)
    x = np.random.RandomState(1).randn(B, T, C).astype(np.float32)
    xt = torch.tensor(x).transpose(1, 2).contiguous()
    with torch.no_grad():
        y16 = fr.fused_resblock_cluster(xt, _packed(towers, torch.bfloat16), SPEC,
                                        mm_dtype=torch.bfloat16).transpose(1, 2)
        y32 = fr.fused_resblock_cluster(xt, _packed(towers), SPEC).transpose(1, 2)
    ref = np.asarray(jax_fused(jnp.asarray(x), _jax_params(towers), KS, DILS, Tt=128,
                               mm_dtype=jnp.bfloat16))
    tol = 3e-4 * max(1.0, float(np.abs(ref).max()))
    agree(y16, ref, tol, "bf16 plain vs JAX Pallas kernel (bf16)")
    assert float(np.abs(y32.numpy() - ref).max()) > tol, "f32 operands pass the bf16 bound"


def test_bf16_packing_equals_jax_bit_for_bit():
    """``pack_tower(..., bf16)`` = JAX ``_pack_tower(..., mm_dtype=bf16)``:
    weights [n, C_out, k*C_in] bf16 (tap-major, c_in-minor), biases f32."""
    C = 32
    for tm, (k, dils), p in zip(_towers(C), SPEC, _jax_params(_towers(C))):
        ours = fr.pack_tower(tm.convs1, tm.convs2, torch.bfloat16)
        theirs = _pack_tower(p, k, dils, "conv1", "conv2", jnp.bfloat16)
        for o, t in zip(ours, theirs):
            t = np.asarray(t)
            if o.dtype == torch.bfloat16:
                o = o.reshape(len(dils), C, k * C).view(torch.int16).numpy()
                t = t.view(np.int16)
            else:
                assert o.dtype == torch.float32 and t.dtype == np.float32
                o = o.detach().numpy()
            np.testing.assert_array_equal(o, t)


def test_mm_dtype_none_picks_f32_on_cpu():
    """``None`` = by device: f32 on the CPU (bf16 on CUDA), for the op and
    for the generator, which packs its weights per mm dtype."""
    assert fr.resolve_mm_dtype(None, torch.device("cpu")) == torch.float32
    assert fr.resolve_mm_dtype(None, torch.device("cuda", 0)) == torch.bfloat16
    with pytest.raises(ValueError, match="mm_dtype"):
        fr.resolve_mm_dtype(torch.float16, torch.device("cpu"))
    towers = _towers(32)
    x = torch.randn(1, 32, 90, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = fr.fused_resblock_cluster(x, _packed(towers), SPEC)
        y32 = fr.resblock_cluster_plain(x, _packed(towers), SPEC, torch.float32)
        y16 = fr.resblock_cluster_plain(x, _packed(towers), SPEC, torch.bfloat16)
    assert torch.equal(y, y32) and not torch.equal(y, y16)

    gen = seeded(lambda: HifiGanGenerator(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                                          upsample_initial_channel=32,
                                          use_pitch_embed=False), 5).eval()
    mel = torch.randn(1, 12, 80, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        wav = gen(mel)
        gen.mm_dtype = torch.float32
        wav32 = gen(mel)
        gen.mm_dtype = torch.bfloat16
        wav16 = gen(mel)
    assert set(gen._packed) == {torch.float32, torch.bfloat16}
    assert gen._packed[torch.bfloat16][0][0].dtype == torch.bfloat16
    assert torch.equal(wav, wav32) and not torch.equal(wav, wav16)


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


# (dtype, B, C, T, zero stretch, needs dL/dx): C 64 / 128 / 256 scaled down by
# 8, lengths that no tile divides; a zero stretch with zero biases keeps
# whole runs of every cur and y at exactly 0, where lrelu' must be 1
TWIN_CASES = [(dt, *shape, zeros, need_dx)
              for dt in (torch.float64, torch.float32)
              for shape, zeros, need_dx in (((2, 8, 131), False, True),
                                            ((1, 16, 77), True, True),
                                            ((2, 32, 45), False, True),
                                            ((1, 16, 77), True, False))]


@pytest.mark.parametrize("dtype,B,C,T,zeros,need_dx", TWIN_CASES)
def test_backward_twin_matches_autograd(dtype, B, C, T, zeros, need_dx):
    """``resblock_cluster_backward_plain`` (the CUDA backward's
    decomposition) against autograd through ``resblock_cluster_plain``:
    dL/dx and every tower's dW and db, within 1e-10 of each tensor's scale
    in float64 and 1e-4 in float32. In float32 the twin runs as the op's
    backward (``fused_resblock_cluster`` on CPU tensors), with ``x`` not
    requiring grad in the ``need_dx`` False cases."""
    gen = torch.Generator().manual_seed(C + T)
    towers = _towers(C, seed=C)
    w = [t.detach().to(dtype) for t in _packed(towers)]
    x = torch.randn(B, C, T, generator=gen, dtype=dtype)
    g = torch.randn(B, C, T, generator=gen, dtype=dtype)
    if zeros:
        x[..., 20:60] = 0
        for t in w[1::2]:  # the biases
            t.zero_()

    xr = x.clone().requires_grad_(need_dx)
    wr = [t.clone().requires_grad_(True) for t in w]
    (fr.resblock_cluster_plain(xr, wr, SPEC) * g).sum().backward()
    want = ([xr.grad] if need_dx else []) + [t.grad for t in wr]

    if dtype == torch.float64:
        gx, gw = fr.resblock_cluster_backward_plain(x, w, SPEC, g, need_dx)
        assert (gx is None) != need_dx
        got = ([gx] if need_dx else []) + gw
        tol = 1e-10
    else:
        xt = x.clone().requires_grad_(need_dx)
        wt = [t.clone().requires_grad_(True) for t in w]
        (fr.fused_resblock_cluster(xt, wt, SPEC) * g).sum().backward()
        assert (xt.grad is None) != need_dx
        got = ([xt.grad] if need_dx else []) + [t.grad for t in wt]
        tol = 1e-4
    assert len(got) == len(want) == int(need_dx) + 4 * len(SPEC)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= tol * scale, f"gradient {i}: {err} > {tol} * {scale}"
    if zeros:  # the stretch's inside is exactly 0 in the first conv's input
        assert bool((x[..., 30:50] == 0).all())


def test_backward_launch_count():
    """Launches of the CUDA backward per stage: 6 per tower step, one less
    per tower without dL/dx (its last dgrad)."""
    assert fr.backward_launches(SPEC) == 54
    assert fr.backward_launches(SPEC, need_dx=False) == 51
    assert fr.resblock_cluster_backward_cuda in fr.KERNEL_COUNTERS


def test_cpu_wrapper_refuses_other_dtypes():
    x = torch.zeros(1, 32, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        fr.fused_resblock_cluster(x, _packed(_towers(32)), SPEC)


def _tf32_off():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The f32 CUDA kernel vs the plain version at a flagship stage shape,
    TF32 off (cuDNN would otherwise round the plain version's convs)."""
    _tf32_off()
    towers = [t.cuda() for t in _towers(128)]
    x = torch.randn(2, 128, 4000, device="cuda")
    with torch.no_grad():
        w = _packed(towers)
        before = fr.resblock_conv1d.launches
        y = fr.fused_resblock_cluster(x, w, SPEC, torch.float32)
        ref = fr.resblock_cluster_plain(x, w, SPEC)
    torch.cuda.synchronize()
    assert fr.resblock_conv1d.launches - before == 18
    assert float((y - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T", [(2, 128, 4000), (1, 64, 4096), (1, 256, 1000)])
def test_bf16_kernel_matches_plain_bf16_on_card(B, C, T):
    """The tensor-core kernel (the default on CUDA) vs the plain version
    with bf16 operands, TF32 off: max|d| <= 1e-3 * max(1, max|ref|), and
    mean|d| at most half the bf16-vs-f32 gap. Two f32 summation orders of
    the same bf16 towers sit up to about 0.37 of the gap apart at C = 256
    (rounding flips compound through the six bf16 convs of a tower); f32
    operands sit at about 1.0."""
    _tf32_off()
    towers = [t.cuda() for t in _towers(C)]
    x = torch.randn(B, C, T, device="cuda")
    with torch.no_grad():
        w = _packed(towers, torch.bfloat16)
        before = (fr.resblock_conv1d_bf16.launches, fr.lrelu_bf16.launches)
        y = fr.fused_resblock_cluster(x, w, SPEC)
        ref = fr.resblock_cluster_plain(x, w, SPEC, torch.bfloat16)
        ref32 = fr.resblock_cluster_plain(x, _packed(towers), SPEC)
    torch.cuda.synchronize()
    assert (fr.resblock_conv1d_bf16.launches - before[0],
            fr.lrelu_bf16.launches - before[1]) == (18, 1)
    d = (y - ref).abs()
    assert float(d.max()) <= 1e-3 * max(1.0, float(ref.abs().max()))
    assert float(d.mean()) <= 0.5 * float((ref - ref32).abs().mean())
