"""BigVGAN-v2 in the port against the plain reference
``svb_bench/reference/bigvgan.py`` (the benchmark's frozen copy, which
imports nothing of the port) on the CPU, at tiny widths: the
Kaiser-sinc filter, ``Activation1d`` (the plain twins of the AMP kernels),
the generator's forward and gradients, the multi-resolution
discriminator, one ``BigVGANTask`` step against a plain step, and the
recipe through the CLI's config path and the CLI itself."""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder  # noqa: E402
from neuralsvb_torch.models import bigvgan as port  # noqa: E402
from neuralsvb_torch.ops import amp_activation as amp  # noqa: E402
from svb_bench.harness import tf32  # noqa: E402
from svb_bench.reference import bigvgan as ref  # noqa: E402
from svb_bench.reference.bigvgan_step import BigVGANStep  # noqa: E402
from tests.test_torch_support import one_torch_thread  # noqa: E402,F401

# the test workers share the host's cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def float32_convolutions():
    """The reference rounds its convolutions' operands to TF32 on the CPU
    while ``cudnn.allow_tf32`` is on (its control), as it is by default."""
    with tf32(False):
        yield

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "egs/datasets/audio/PopBuTFy/bigvgan_v2_24k_torch.yaml")
# six stages at the published rates; 64 channels halve down to 1
TINY_GEN = dict(num_mels=100, upsample_rates=(4, 4, 2, 2, 2, 2),
                upsample_kernel_sizes=(8, 8, 4, 4, 4, 4), upsample_initial_channel=64)
TINY_HP = dict(upsample_initial_channel=64, max_samples=1024, max_sentences=2, seed=5,
               ds_workers=0)


def test_kaiser_sinc_filter_is_the_formula():
    f = amp.FILTER.double().numpy()
    assert torch.equal(amp.FILTER, ref.kaiser_sinc_filter1d())
    # the formula in float64 with numpy's Kaiser window: A = 51.03, beta = 4.6648
    a = 2.285 * 5 * math.pi * 4 * 0.3 + 7.95
    t = np.arange(-6, 6) + 0.5
    want = 0.5 * np.kaiser(12, 0.1102 * (a - 8.7)) * np.sinc(0.5 * t)
    want /= want.sum()
    # float32 taps of a float32 computation: a few ulps of taps below 0.3
    np.testing.assert_allclose(f, want, rtol=0, atol=1e-7)
    assert abs(f.sum() - 1.0) < 1e-6
    np.testing.assert_allclose(f, f[::-1], rtol=0, atol=1e-7)


def _amp_inputs(T, dtype, seed=0, C=3, B=2):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(B, C, T, generator=g)).to(dtype)
    a = (0.3 * torch.randn(C, generator=g)).to(dtype)
    b = (0.3 * torch.randn(C, generator=g)).to(dtype)
    gy = torch.randn(B, C, T, generator=g).to(dtype)
    return x, a, b, gy


@pytest.mark.parametrize("T", [1, 5, 16, 37, 600])
def test_activation1d_twin_matches_reference(T):
    x, a, b, _ = _amp_inputs(T, torch.float32)
    want = ref.activation1d(x, a, b)
    for got in (amp.activation1d_plain(x, a, b), amp.amp_activation(x, a, b)):
        # the same float32 operations in the same order: equal to rounding
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        # the replicate-padded edges: the first and last 8 samples
        torch.testing.assert_close(got[..., :8], want[..., :8], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[..., -8:], want[..., -8:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 2e-5)])
@pytest.mark.parametrize("T", [1, 6, 37, 600])
def test_activation1d_gradients_match_reference(T, dtype, tol):
    """The written-out backward (the kernels' decomposition, which the CPU
    path runs) against autograd through the reference; float64 checks the
    algebra, float32 that the two orders of summation agree to rounding."""
    x, a, b, gy = _amp_inputs(T, dtype, seed=T)
    leaves = [t.clone().requires_grad_() for t in (x, a, b)]
    ref.activation1d(*leaves).backward(gy)
    mine = [t.clone().requires_grad_() for t in (x, a, b)]
    amp.amp_activation(*mine).backward(gy)
    for name, got, want in zip("xab", mine, leaves):
        scale = max(1.0, float(want.grad.abs().max()))
        err = float((got.grad - want.grad).abs().max()) / scale
        assert err < tol, (name, err)
    # the edges of dx (the folded padding) on their own
    torch.testing.assert_close(mine[0].grad[..., :8], leaves[0].grad[..., :8],
                               rtol=tol, atol=tol)
    torch.testing.assert_close(mine[0].grad[..., -8:], leaves[0].grad[..., -8:],
                               rtol=tol, atol=tol)


def _pair(cls_port, cls_ref, seed=0, **kw):
    torch.manual_seed(seed)
    m_ref = cls_ref(**kw)
    m_port = cls_port(**kw)
    # the same seeded weights (alpha and beta off their zero init)
    with torch.no_grad():
        for p in m_ref.parameters():
            if p.dim() == 1 and float(p.abs().max()) == 0:
                p.normal_(0, 0.1)
    missing = m_port.load_state_dict(m_ref.state_dict(), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return m_port, m_ref


def test_generator_forward_and_gradients_match_reference():
    g_port, g_ref = _pair(port.BigVGANGenerator, ref.BigVGAN, **TINY_GEN)
    g_port, g_ref = g_port.double(), g_ref.double()
    mel = torch.randn(2, 5, 100, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    y_port, y_ref = g_port(mel), g_ref(mel)
    assert y_port.shape == (2, 5 * 256)
    assert 0.05 < float((y_ref.abs() < 1).double().mean())  # the clamp passes a share
    torch.testing.assert_close(y_port, y_ref, rtol=1e-10, atol=1e-10)
    w = torch.randn_like(y_ref)
    (y_port * w).sum().backward()
    (y_ref * w).sum().backward()
    ref_params = dict(g_ref.named_parameters())
    for name, p in g_port.named_parameters():
        q = ref_params[name]
        # float64: the written-out AMP backward against autograd's
        scale = max(1e-12, float(q.grad.abs().max()))
        assert float((p.grad - q.grad).abs().max()) / scale < 1e-8, name
    # float32 forward: the same operations, rounding apart
    y32 = g_port.float()(mel.float())
    torch.testing.assert_close(y32, g_ref.float()(mel.float()), rtol=1e-4, atol=1e-4)


def test_mrd_outputs_and_feature_maps_match_reference():
    d_port, d_ref = _pair(port.MultiResolutionDiscriminator, ref.MultiResolutionDiscriminator)
    y = 0.3 * torch.randn(2, 2400, generator=torch.Generator().manual_seed(2))
    (o_p, f_p), (o_r, f_r) = d_port(y), d_ref(y)
    assert len(o_p) == len(o_r) == 3
    for a, b in zip(o_p, o_r):
        # |STFT| as complex abs vs the norm of (re, im): rounding apart
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for fa, fb in zip(f_p, f_r):
        assert len(fa) == len(fb) == 6
        for a, b in zip(fa, fb):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def write_split(data_dir, seconds, prefix, seed, hop=256, sr=24000, n_mels=100):
    """A packed 24 kHz split with ``wav`` and a 100-bin ``mel`` per item."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    b = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    for i, s in enumerate(seconds):
        T = int(s * sr) // hop
        t = np.arange(T * hop) / sr
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(110, 440) * t) + 0.01 * rng.randn(T * hop)
        b.add_item({"item_name": f"{prefix}_{i}", "wav": wav.astype(np.float32),
                    "mel": (rng.randn(T, n_mels) - 4).astype(np.float32)})
    b.finalize()


def _recipe_hparams(tmp_path, **extra):
    from neuralsvb_torch.hparams import set_hparams
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(dict(TINY_HP, base_config=[RECIPE], **extra)))
    return set_hparams(config=str(cfg), print_hparams=False, global_hparams=False)


def test_recipe_loads_through_the_cli_config_path(tmp_path):
    from neuralsvb_torch.hparams import set_hparams
    hp = set_hparams(config=RECIPE, print_hparams=False, global_hparams=False)
    assert hp["task_cls"] == "neuralsvb_torch.tasks.vocoder_task.BigVGANTask"
    assert hp["upsample_initial_channel"] == 1536
    assert list(hp["upsample_rates"]) == [4, 4, 2, 2, 2, 2]
    assert (hp["audio_sample_rate"], hp["hop_size"], hp["audio_num_mel_bins"]) == \
        (24000, 256, 100)
    assert (hp["max_sentences"], hp["max_samples"]) == (4, 65536)
    assert hp["lambda_mel"] == 45.0 and hp["use_fm_loss"] and hp["disc_start_steps"] == -1
    assert math.prod(hp["upsample_rates"]) == hp["hop_size"]


def test_task_step_matches_a_plain_step(tmp_path):
    """One ``Trainer._train_one`` of ``BigVGANTask`` (generator, then MPD
    and MRD, from step 0) against the benchmark's plain step
    (``svb_bench/reference/bigvgan_step.py``) from the same weights and
    batch: both losses and every parameter's change."""
    from neuralsvb_torch.hparams import hparams_scope
    from neuralsvb_torch.tasks.vocoder_task import BigVGANTask
    from neuralsvb_torch.training.trainer import Trainer
    data = tmp_path / "data"
    write_split(str(data), (0.2, 0.15, 0.25), "train", 3)
    hp = _recipe_hparams(tmp_path, binary_data_dir=str(data), device="cpu")
    with hparams_scope(hp):
        task = BigVGANTask()
        trainer = Trainer(work_dir="")
        task.trainer = trainer
        task.build_model()
        task.build_train()
        mods = {"gen": task.model, "mpd": task.mpd, "mrd": task.mrd}
        torch.manual_seed(0)
        plain = BigVGANStep(dict(hp), TINY_GEN, torch.device("cpu"))
        refs = plain.modules()
        with torch.no_grad():
            for p in refs["gen"].parameters():
                if p.dim() == 1:  # alpha, beta and biases off zero
                    p.normal_(0, 0.1)
        for k in mods:
            mods[k].load_state_dict(refs[k].state_dict())
        before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
                  for k, m in mods.items()}
        batch = next(iter(task.train_dataloader()))
        trainer._set_step(task, 0)
        logs = trainer._train_one(task, batch)
        want_logs = plain.step(batch, 0)
    t0, t1 = want_logs["total_loss_0"], want_logs["total_loss_1"]
    assert set(logs) >= {"mel", "a_p", "a_r", "fm", "r_p", "f_p", "r_r", "f_r"}
    # float32 sums of the same terms in other orders
    assert abs(float(logs["total_loss_0"]) - t0) <= 1e-5 * abs(t0)
    assert abs(float(logs["total_loss_1"]) - t1) <= 1e-5 * abs(t1)
    lr = 1e-4
    for k, m in mods.items():
        want = dict(refs[k].named_parameters())
        for n, p in m.named_parameters():
            d_got = p.detach() - before[k][n]
            d_want = want[n].detach() - before[k][n]
            # Adam's first step moves each entry by about lr x sign(g): an
            # entry whose gradient is at rounding level may take the other
            # sign, so count such entries instead of bounding the largest
            off = (d_got - d_want).abs() > 0.1 * lr
            assert float(d_want.abs().max()) > 0.5 * lr, (k, n)
            assert int(off.sum()) <= max(1, d_want.numel() // 1000), (k, n, int(off.sum()))


def test_cli_trains_the_recipe(tmp_path):
    """``python -m neuralsvb_torch.tasks.run --config`` on the recipe at
    tiny widths: two steps through ``Trainer`` and ``BigVGANTask``, a
    checkpoint with ``model_gen``, ``mpd`` and ``mrd``, and the summary's
    AMP launch counters (0 on the CPU, where the plain twins run)."""
    data = tmp_path / "data"
    write_split(str(data), (0.2, 0.3), "train", 4)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(dict(TINY_HP, base_config=[RECIPE], binary_data_dir=str(data),
                                       max_updates=2, num_sanity_val_steps=0,
                                       val_check_interval=100, tb_log_interval=1)))
    out = subprocess.run(
        [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config", str(cfg), "--hparams",
         f"device=cpu,work_dir={tmp_path / 'work'}"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    steps = re.findall(r"^\| step (\d+): ", out.stdout, re.M)
    assert steps == ["1", "2"]
    assert '"amp_forward_cuda_launches": 0' in out.stdout
    ckpt = torch.load(tmp_path / "work" / "model_ckpt_steps_2.ckpt", weights_only=True)
    assert set(ckpt["state_dict"]) == {"model_gen", "mpd", "mrd"}
