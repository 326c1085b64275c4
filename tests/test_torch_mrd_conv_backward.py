"""The backward of BigVGAN's multi-resolution discriminator
(``ops/mrd_conv.py``): the plain twin of the CUDA kernels against autograd
through ``F.conv2d`` and the leaky-ReLU in float64 at small shapes of the
MRD's four layer geometries, the MRD through ``mrd_conv2d`` against the
benchmark's plain reference (``svb_bench/reference/bigvgan.py``) on the
CPU, the gradients the Function skips, the generator's input gradient
through the Function, the wrapper's refusals, its wgrad slices and its
bindings. The kernels themselves run in the tests marked
``cuda`` and in ``chip_smoke.py --mrd-conv-bwd``."""

from __future__ import annotations

import ctypes
import re
import types

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from neuralsvb_torch.models import bigvgan as port  # noqa: E402
from neuralsvb_torch.ops import mrd_conv  # noqa: E402
from neuralsvb_torch.training import trainer  # noqa: E402
from svb_bench.harness import tf32  # noqa: E402
from svb_bench.reference import bigvgan as ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer_case(kw, sw, ci, co, B=2, H=7, wi=23, dtype=torch.float64, seed=0):
    """x, w, b of one MRD layer and an output gradient; x is zero over a
    band of columns wider than the kernel and the first half of the biases
    is 0, so that the pre-activation is exactly 0 at some positions."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, ci, H, wi, generator=gen, dtype=dtype)
    x[..., 2:2 + kw + 2 * sw + 2] = 0
    w = torch.randn(co, ci, 3, kw, generator=gen, dtype=dtype) / (ci * 3 * kw) ** 0.5
    b = torch.randn(co, generator=gen, dtype=dtype)
    b[:(co + 1) // 2] = 0
    wo = (wi + 2 * (kw // 2) - kw) // sw + 1
    dy = torch.randn(B, co, H, wo, generator=gen, dtype=dtype)
    return x, w, b, dy


def _forward(x, w, b, sw, lrelu):
    pre = F.conv2d(x, w, b, (1, sw), (1, w.shape[-1] // 2))
    return torch.where(pre >= 0, pre, pre * mrd_conv.LRELU_SLOPE) if lrelu else pre


def _autograd(x, w, b, dy, sw, lrelu):
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = _forward(xs, ws, bs, sw, lrelu)
    y.backward(dy)
    return y.detach(), (xs.grad, ws.grad, bs.grad)


@pytest.mark.parametrize("wi", [23, 30])
@pytest.mark.parametrize("kw,sw,ci,co", mrd_conv.GEOMETRIES)
def test_plain_twin_matches_autograd(kw, sw, ci, co, wi):
    """dx, dW and db of the twin's decomposition equal autograd through
    ``F.conv2d`` and the leaky-ReLU (derivative 1 at exactly 0) in float64,
    at an odd and an even input width (the stride-2 layers' output
    padding); the pre-activation is exactly 0 at some positions."""
    lrelu = co != 1
    x, w, b, dy = _layer_case(kw, sw, ci, co, wi=wi, seed=kw + sw + ci + wi)
    y, want = _autograd(x, w, b, dy, sw, lrelu)
    assert bool((y == 0).any())
    got = mrd_conv.mrd_conv_backward_plain(x, w, y, dy, sw, lrelu)
    for name, a, r in zip(("dx", "dW", "db"), got, want):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        err = float((a - r).abs().max())
        assert err <= 1e-12 * max(1.0, float(r.abs().max())), f"{name}: {err}"


def test_function_forward_is_conv_then_leaky_relu():
    """The Function's forward is ``F.conv2d`` and the activation, bit for
    bit, with and without the activation."""
    for kw, sw, ci, co in mrd_conv.GEOMETRIES:
        x, w, b, _ = _layer_case(kw, sw, ci, co, dtype=torch.float32)
        want = _forward(x, w, b, sw, co != 1)
        assert torch.equal(mrd_conv.mrd_conv2d(x, w, b, sw, co != 1), want)


def _mrd_pair(seed=0):
    torch.manual_seed(seed)
    m_ref = ref.MultiResolutionDiscriminator()
    m_port = port.MultiResolutionDiscriminator()
    res = m_port.load_state_dict(m_ref.state_dict(), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return m_port.double(), m_ref.double()


def _mrd_grads(mrd, y):
    """The input's and every parameter's gradient of a seeded random
    weighting of the scores and of every feature map (as the generator's
    adversarial and feature matching losses reach them)."""
    mrd.zero_grad(set_to_none=True)
    ys = y.clone().requires_grad_(True)
    outs, fmaps = mrd(ys)
    terms = [o.flatten() for o in outs] + [f.flatten() for fm in fmaps for f in fm]
    gen = torch.Generator().manual_seed(5)
    loss = sum((t * torch.randn(t.numel(), generator=gen, dtype=t.dtype)).sum() for t in terms)
    loss.backward()
    return ys.grad, {n: p.grad for n, p in mrd.named_parameters()}


def test_mrd_gradients_match_reference():
    """The port's MRD (every convolution through ``mrd_conv2d``, backward in
    the plain twin) against the benchmark's plain reference (``nn.Conv2d``
    and ``F.leaky_relu``) in float64: the gradient of the input signal and
    of every parameter within 1e-9 of its scale."""
    with tf32(False):
        d_port, d_ref = _mrd_pair()
        gen = torch.Generator().manual_seed(4)
        y = 0.3 * torch.randn(2, 2400, generator=gen, dtype=torch.float64)
        gx_p, gp = _mrd_grads(d_port, y)
        gx_r, gr = _mrd_grads(d_ref, y)
    assert len(gp) == len(gr) == 3 * 12
    err = float((gx_p - gx_r).abs().max()) / float(gx_r.abs().max())
    assert err < 1e-9, f"input: {err}"
    for name, g in gp.items():
        r = gr[name]
        err = float((g - r).abs().max()) / max(1e-12, float(r.abs().max()))
        assert err < 1e-9, f"{name}: {err}"


@pytest.mark.parametrize("needs", ["weights", "input"])
def test_function_skips_the_gradients_not_asked_for(needs, monkeypatch):
    """The backward computes dx only when the input needs a gradient (the
    discriminator's update, whose input is data) and dW, db only when the
    parameters do (the generator's update, which freezes them); what it
    computes equals autograd's."""
    calls = []
    plain = mrd_conv.mrd_conv_backward_plain

    def recorded(*args, **kw):
        calls.append((kw["need_dx"], kw["need_dw"]))
        return plain(*args, **kw)

    monkeypatch.setattr(mrd_conv, "mrd_conv_backward_plain", recorded)
    x, w, b, dy = _layer_case(9, 2, 32, 32, H=5, wi=21)
    want = _autograd(x, w, b, dy, 2, True)[1]
    on_x = needs == "input"
    xs = x.clone().requires_grad_(on_x)
    ws, bs = (t.clone().requires_grad_(not on_x) for t in (w, b))
    mrd_conv.mrd_conv2d(xs, ws, bs, 2, True).backward(dy)
    assert calls == [(on_x, not on_x)]
    got = [xs.grad] if on_x else [ws.grad, bs.grad]
    for a, r in zip(got, [want[0]] if on_x else list(want[1:])):
        assert torch.allclose(a, r, rtol=0, atol=1e-12)
    if on_x:
        assert ws.grad is None and bs.grad is None
    else:
        assert xs.grad is None


@pytest.mark.parametrize("kw,sw,ci,co", mrd_conv.GEOMETRIES)
def test_input_grad_alone_is_autograds(kw, sw, ci, co):
    """The generator's update (parameters frozen) takes dx alone through
    the Function, the first layer's (the spectrogram's) included, as
    autograd computes it through ``F.conv2d`` and the activation, in
    float64; the pre-activation is exactly 0 at some positions."""
    lrelu = co != 1
    x, w, b, dy = _layer_case(kw, sw, ci, co, seed=kw * sw + co)
    xs = x.clone().requires_grad_(True)
    want, = torch.autograd.grad(_forward(xs, w, b, sw, lrelu), xs, dy)
    got, = torch.autograd.grad(mrd_conv.mrd_conv2d(xs, w, b, sw, lrelu), xs, dy)
    err = float((got - want).abs().max())
    assert err <= 1e-12 * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("change", ["dtype", "kernel_width", "stride", "channels",
                                    "activation", "output_shape", "rank", "nothing", "device"])
def test_wrapper_refuses_what_it_does_not_take(change):
    x, w, b, dy = _layer_case(9, 2, 32, 32, dtype=torch.float32)
    y = _forward(x, w, b, 2, True)
    sw, lrelu, asked = 2, True, {}
    if change == "nothing":
        asked = dict(need_dx=False, need_dw=False)
    if change == "dtype":
        x = x.double()
    elif change == "kernel_width":
        w = w[..., :7].contiguous()
    elif change == "stride":
        sw = 3
    elif change == "channels":
        w = w[:16]
    elif change == "activation":
        lrelu = False
    elif change == "output_shape":
        dy = dy[..., :5]
    elif change == "rank":
        x = x[0]
    match = {"device": "CUDA kernels", "nothing": "nothing"}.get(change, "takes|must be")
    with pytest.raises(ValueError, match=match):
        mrd_conv.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu, **asked)


def test_backward_on_another_device_raises():
    x, w, b, dy = _layer_case(3, 1, 32, 32, dtype=torch.float32)
    y = mrd_conv.mrd_conv2d(x.to("meta").requires_grad_(True), w.to("meta"), None, 1, True)
    with pytest.raises(ValueError, match="no backward"):
        y.backward(torch.ones_like(y))


def test_slices_and_counter():
    """The wgrad's slices at the bigvgan_train cell's layer shapes (4 crops
    of 65536 samples): about WGRAD_BLOCKS blocks (three a slice for the
    stride-2 layers, one a kernel row), at least 16 work items a slice; the
    counter is in the trainer's list."""
    # (kw, ci, co, H, Wo): resolution 1024's first, second and last layers,
    # resolution 2048's fourth
    assert mrd_conv.wgrad_slices(9, 1, 32, 4, 513, 546) == 792
    assert mrd_conv.wgrad_slices(9, 32, 32, 4, 513, 273) == 264
    assert mrd_conv.wgrad_slices(3, 32, 1, 4, 513, 69) == 384  # 6,156 items
    assert mrd_conv.wgrad_slices(9, 32, 32, 4, 1025, 35) == 264
    assert mrd_conv.wgrad_slices(3, 32, 32, 1, 5, 20) == 1  # 5 items
    assert mrd_conv.mrd_conv_backward_cuda in trainer.COUNTERS


def test_bindings_match_the_c_interface():
    """Every entry point of ``csrc/mrd_conv_backward.cu`` is bound with one
    ctypes type per C parameter, pointers as ``c_void_p``."""
    src = mrd_conv.SOURCE.read_text()
    lib = types.SimpleNamespace()
    entries = re.findall(r'extern "C" int (nsvb_\w+)\(([^)]*)\)', src)
    for name, _ in entries:
        setattr(lib, name, types.SimpleNamespace())
    mrd_conv._bind(lib)
    assert {n for n, _ in entries} == {"nsvb_mrd_dgrad", "nsvb_mrd_wgrad"}
    for name, params in entries:
        params = [p.strip() for p in params.split(",")]
        argtypes = getattr(lib, name).argtypes
        assert len(argtypes) == len(params), name
        for p, t in zip(params, argtypes):
            if "*" in p:
                assert t is ctypes.c_void_p, (name, p)
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, (name, p)
            else:
                assert p.startswith("int") and t is ctypes.c_int, (name, p)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("kw,sw,ci,co", mrd_conv.GEOMETRIES)
@pytest.mark.parametrize("H,wi", [(37, 101), (18, 64)])
def test_kernels_match_twin_on_card(kw, sw, ci, co, H, wi):
    """The kernels against the plain twin in f32 (TF32 off) at ragged
    shapes, x with its height innermost (as the STFT gives the first
    layer's): dx, dW and db within 1e-4 of their scale, two calls
    bit-equal, dx alone (the generator's call) bit-equal to dx beside the
    wgrad, one count a call."""
    _card()
    x, w, b, dy = (t.float().cuda() for t in _layer_case(kw, sw, ci, co, B=3, H=H, wi=wi))
    x = x.transpose(2, 3).contiguous().transpose(2, 3)
    lrelu = co != 1
    y = _forward(x, w, b, sw, lrelu)
    before = mrd_conv.mrd_conv_backward_cuda.launches
    got = mrd_conv.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu)
    again = mrd_conv.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu)
    alone = mrd_conv.mrd_conv_backward_cuda(x, w, y, dy, sw, lrelu, need_dw=False)
    want = mrd_conv.mrd_conv_backward_plain(x, w, y, dy, sw, lrelu)
    torch.cuda.synchronize()
    assert mrd_conv.mrd_conv_backward_cuda.launches - before == 3
    assert alone[1] is None and alone[2] is None and torch.equal(alone[0], got[0])
    for a, a2, r in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))
