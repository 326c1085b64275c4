"""The backward of BigVGAN's AMP-tower convolutions (``ops/amp_conv.py``):
the plain twin of the CUDA kernels against autograd through ``F.conv1d``
in float64 at small shapes, ``AMPBlock1`` through ``amp_conv1d`` against
the same block through plain ``nn.Conv1d`` on the CPU, the wrapper's
refusals and its tiles. The kernels themselves run in the tests marked
``cuda`` and in ``chip_smoke.py --amp-conv-bwd``."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from neuralsvb_torch.models import bigvgan  # noqa: E402
from neuralsvb_torch.ops import amp_conv  # noqa: E402
from neuralsvb_torch.ops import dilated_conv as dc  # noqa: E402
from neuralsvb_torch.training import trainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_case(B, C, T, K, d, dtype=torch.float64, seed=0, co=None):
    gen = torch.Generator().manual_seed(seed)
    co = C if co is None else co
    x = torch.randn(B, C, T, generator=gen, dtype=dtype)
    w = torch.randn(co, C, K, generator=gen, dtype=dtype) / (C * K) ** 0.5
    b = torch.randn(co, generator=gen, dtype=dtype)
    g = torch.randn(B, co, T, generator=gen, dtype=dtype)
    return x, w, b, g


def _autograd(x, w, b, g, d):
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    K = w.shape[-1]
    F.conv1d(xs, ws, bs, padding=(K - 1) // 2 * d, dilation=d).backward(g)
    return xs.grad, ws.grad, bs.grad


@pytest.mark.parametrize("C", [24, 40, 64])
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("K", [3, 7, 11])
def test_plain_twin_matches_autograd(K, d, C):
    """dx, dW and db of the twin's decomposition equal autograd through
    ``F.conv1d`` in float64; T = 37 puts the padding of K = 11 at d = 5 on
    both sides of every position."""
    x, w, b, g = _conv_case(2, C, 37, K, d, seed=K * 100 + d * 10 + C)
    want = _autograd(x, w, b, g, d)
    got = amp_conv.amp_conv_backward_plain(x, w, g, d)
    for name, a, r in zip(("dx", "dW", "db"), got, want):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        err = float((a - r).abs().max())
        assert err <= 1e-12 * max(1.0, float(r.abs().max())), f"{name}: {err}"


def test_plain_twin_takes_other_output_widths():
    x, w, b, g = _conv_case(3, 16, 29, 7, 3, co=24, seed=3)
    for a, r in zip(amp_conv.amp_conv_backward_plain(x, w, g, 3), _autograd(x, w, b, g, 3)):
        assert torch.allclose(a, r, rtol=0, atol=1e-12)


def _block_grads(block, x, g, plain):
    """Output, dL/dx and every parameter's gradient of ``block`` at x for
    the output gradient g; ``plain`` calls its convolutions as the
    ``nn.Conv1d`` modules they are."""
    block.zero_grad(set_to_none=True)
    xs = x.clone().requires_grad_(True)
    if plain:
        h = xs
        for c1, c2, a1, a2 in zip(block.convs1, block.convs2, block.activations[::2],
                                  block.activations[1::2]):
            h = c2(a2(c1(a1(h)))) + h
        y = h
    else:
        y = block(xs)
    y.backward(g)
    return [y.detach(), xs.grad] + [p.grad for p in block.parameters()]


@pytest.mark.parametrize("K", [3, 7, 11])
def test_ampblock_through_the_function_equals_plain_conv1d(K):
    """AMPBlock1 (dilations 1, 3, 5) through ``amp_conv1d`` against the
    same block through plain ``nn.Conv1d`` on the CPU, float64: the output
    bit for bit (the forward is the same ``F.conv1d``), every gradient
    within 1e-10 of its scale."""
    torch.manual_seed(K)
    block = bigvgan.AMPBlock1(24, K, (1, 3, 5)).double()
    for p in block.parameters():
        p.data.normal_(0, 0.2)
    x = torch.randn(2, 24, 61, dtype=torch.float64)
    g = torch.randn(2, 24, 61, dtype=torch.float64)
    got = _block_grads(block, x, g, plain=False)
    want = _block_grads(block, x, g, plain=True)
    assert torch.equal(got[0], want[0])
    assert len(got) == len(want) == 2 + 2 * 6 + 2 * 6
    for i, (a, r) in enumerate(zip(got[1:], want[1:])):
        assert a.shape == r.shape
        err = float((a - r).abs().max())
        assert err <= 1e-10 * max(1.0, float(r.abs().max())), f"gradient {i}: {err}"


def test_function_skips_the_gradients_not_asked_for():
    x, w, b, g = _conv_case(1, 24, 20, 3, 1)
    ws = w.clone().requires_grad_(True)
    y = amp_conv.amp_conv1d(x, ws, None, 1)
    y.backward(g)
    assert torch.allclose(ws.grad, _autograd(x, w, b, g, 1)[1], rtol=0, atol=1e-12)
    assert torch.equal(y, F.conv1d(x, w, None, padding=1))


@pytest.mark.parametrize("change", ["dtype", "kernel_size", "weight_shape", "grad_shape",
                                    "dilation", "rank", "device"])
def test_wrapper_refuses_what_it_does_not_take(change):
    x, w, _, g = _conv_case(2, 24, 16, 7, 1, dtype=torch.float32)
    d = 1
    if change == "dtype":
        x = x.double()
    elif change == "kernel_size":
        w = w[..., :5].contiguous()
    elif change == "weight_shape":
        w = w[:, :16]
    elif change == "grad_shape":
        g = g[..., :8]
    elif change == "dilation":
        d = 0
    elif change == "rank":
        x = x[0]
    match = "CUDA kernels" if change == "device" else "takes|must be"
    with pytest.raises(ValueError, match=match):
        amp_conv.amp_conv_backward_cuda(x, w, g, d)


def test_backward_on_another_device_raises():
    x, w, b, g = _conv_case(1, 24, 12, 3, 1, dtype=torch.float32)
    y = amp_conv.amp_conv1d(x.to("meta").requires_grad_(True), w.to("meta"), None, 1)
    with pytest.raises(ValueError, match="no backward"):
        y.backward(torch.ones_like(y))


# the ResBlock cluster's backward shapes (B, C, T, k) and its wgrad slices
# as the cluster's own formula gave them before the two backwards shared
# their kernels: ceil(1056 / (ceil(C / 64) ceil(C / (32 if k <= 5 else 16))))
# blocks, at most B ceil(T / 64)
CLUSTER_SLICES = (((16, 256, 512, 3), 33), ((16, 256, 512, 7), 17), ((16, 256, 512, 11), 17),
                  ((16, 128, 4096, 3), 132), ((16, 128, 4096, 11), 66),
                  ((16, 64, 8192, 3), 528), ((16, 64, 8192, 7), 264), ((1, 64, 704, 5), 11))


def test_tiles_and_slices():
    """The widest channel tile that divides C for the plain instances (so no
    tile masks most of its lanes at the towers' 768 ... 24 channels), 64
    for the cluster's lrelu ones, and wgrad slices bounded by the work
    items: the cluster's as before."""
    assert [dc._tile(c, False) for c in (768, 384, 192, 96, 48, 24, 40)] == \
        [64, 64, 64, 32, 16, 8, 8]
    assert {dc._tile(c, True) for c in (512, 256, 128, 64, 40)} == {64}
    assert dc.wgrad_slices(768, 768, 11, 4, 1024, lrelu=False) == 2
    assert dc.wgrad_slices(24, 24, 3, 4, 65536, lrelu=False) == 352  # 3 x 1 tiles
    assert dc.wgrad_slices(64, 64, 3, 1, 64, lrelu=False) == 1
    for (B, C, T, k), want in CLUSTER_SLICES:
        assert dc.wgrad_slices(C, C, k, B, T, lrelu=True) == want, (B, C, T, k)
        assert dc.wgrad_slices(C, C, k, B, T, lrelu=False) == want, (B, C, T, k)
    assert amp_conv.amp_conv_backward_cuda in trainer.COUNTERS
    assert dc.PLAIN_KS == (3, 7, 11) and dc.LRELU_KS == (3, 5, 7, 9, 11)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T,K,d", [(2, 40, 999, 11, 5), (1, 72, 3000, 3, 3),
                                       (4, 96, 2048, 7, 1), (3, 24, 4100, 11, 3)])
def test_kernels_match_twin_on_card(B, C, T, K, d):
    """The kernels against the plain twin in f32 (TF32 off) at ragged
    shapes: every tensor within 1e-4 of its scale, two calls bit-equal,
    one count a call."""
    _card()
    x, w, b, g = (t.float().cuda() for t in _conv_case(B, C, T, K, d))
    before = amp_conv.amp_conv_backward_cuda.launches
    got = amp_conv.amp_conv_backward_cuda(x, w, g, d)
    again = amp_conv.amp_conv_backward_cuda(x, w, g, d)
    want = amp_conv.amp_conv_backward_plain(x, w, g, d)
    torch.cuda.synchronize()
    assert amp_conv.amp_conv_backward_cuda.launches - before == 2
    for a, a2, r in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))
