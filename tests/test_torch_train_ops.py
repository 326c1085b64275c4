"""The training path's small modules on the PyTorch port vs the JAX package:
SSIM and the mel losses (1e-5), the learning-rate schedules, BatchNorm in
training mode against flax (outputs and running statistics at 1e-5; the
running variance takes the biased batch variance; a batch of one
normalizes to zero in ``GlobalLatentMap``), and the conformer's
collate-length rel-pos mode against JAX ``exact_lengths=False`` (1e-4, the
tolerance of ``test_conformer_padded_batch``)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_support import agree, flax_load, sd_numpy, seeded  # noqa: E402

from neuralsvb_tpu.convert import torch2jax as t2j  # noqa: E402
from neuralsvb_tpu.models import asr as jasr  # noqa: E402
from neuralsvb_tpu.models import common as jcommon  # noqa: E402
from neuralsvb_tpu.models import conformer as jconf  # noqa: E402
from neuralsvb_tpu.models import fvae as jfvae  # noqa: E402
from neuralsvb_tpu.ops import ssim as jssim  # noqa: E402
from neuralsvb_tpu.tasks import svb_vae_task as jtask  # noqa: E402
from neuralsvb_tpu.training import schedulers as jsched  # noqa: E402
from neuralsvb_torch.models import asr as tasr  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402
from neuralsvb_torch.models import conformer as tconf  # noqa: E402
from neuralsvb_torch.models import fvae as tfvae  # noqa: E402
from neuralsvb_torch.ops import ssim as tssim  # noqa: E402
from neuralsvb_torch.tasks import losses as tlosses  # noqa: E402
from neuralsvb_torch.training import schedulers as tsched  # noqa: E402


def _mels(seed, B=2, T=40, lens=(40, 29)):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, 80).astype(np.float32) - 2
    return x * (np.arange(T)[None, :] < np.asarray(lens)[:, None])[:, :, None]


def _prefixed(sd):
    return {f"m.{k}": v for k, v in sd.items()}


def test_ssim_map_and_mean_match_jax():
    """On inputs without constant patches: where both windows are constant
    (padding) the map is a ratio of rounding noise, on either side; the loss
    test below weights those frames out."""
    a, b = _mels(0, lens=(40, 40)) + 6, _mels(1, lens=(40, 40)) + 6
    for size_average in (False, True):
        yt = tssim.ssim(torch.tensor(a)[:, None], torch.tensor(b)[:, None],
                        size_average=size_average)
        yj = jssim.ssim(a[:, None], b[:, None], size_average=size_average)
        agree(yt, yj, 1e-5, f"ssim size_average={size_average}")


@pytest.mark.parametrize("name", ["l1_mel_loss", "ssim_mel_loss"])
def test_mel_losses_match_jax(name):
    out, target = _mels(2, lens=(40, 40)), _mels(3)
    agree(getattr(tlosses, name)(torch.tensor(out), torch.tensor(target)),
          getattr(jtask, name)(out, target), 1e-5, name)


def test_add_mel_loss_and_mse_match_jax():
    spec = "ssim:0.5|l1:0.5"
    assert tlosses.parse_mel_losses(spec) == jtask.parse_mel_losses(spec)
    assert tlosses.parse_mel_losses("l1") == jtask.parse_mel_losses("l1") == {"l1": 1.0}
    out, target = _mels(4), _mels(5)
    lt, lj = {}, {}
    tlosses.add_mel_loss(tlosses.parse_mel_losses(spec), torch.tensor(out),
                         torch.tensor(target), lt, "a2a")
    jtask.add_mel_loss(jtask.parse_mel_losses(spec), out, target, lj, "a2a")
    assert list(lt) == list(lj) == ["ssima2a", "l1a2a"]
    for k in lt:
        agree(lt[k], lj[k], 1e-5, k)
    y = np.random.RandomState(6).randn(3, 2).astype(np.float32)
    agree(tlosses.mse(torch.tensor(y), 1.0), jtask.mse(y, 1.0), 1e-6, "mse")


def test_nan_guard_keeps_the_value_and_drops_the_gradient():
    x = torch.tensor([1.0, float("inf")], requires_grad=True)
    y = tlosses.nan_guard(x * 2)
    assert y[0] == 2.0 and torch.isinf(y[1])
    y[0].backward()
    assert x.grad.tolist() == [2.0, 0.0]


@pytest.mark.parametrize("step", [0, 1, 1999, 2000, 60000, 120001])
def test_schedules_match_jax(step):
    for t, j in ((tsched.rsqrt_schedule(1.0, 2000, 256), jsched.rsqrt_schedule(1.0, 2000, 256)),
                 (tsched.step_lr_schedule(1e-3, 60000, 0.5),
                  jsched.step_lr_schedule(1e-3, 60000, 0.5))):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6)


@pytest.mark.parametrize("B", [1, 3])
def test_batchnorm_train_matches_flax(B):
    """Output and running statistics after two training calls; torch's own
    BatchNorm1d takes the unbiased variance into its running statistics and
    raises on a single value per channel."""
    rng = np.random.RandomState(7)
    C, T = 6, 1 if B == 1 else 5
    xs = [rng.randn(B, C, T).astype(np.float32) * 2 + 1 for _ in range(2)]
    tm = seeded(lambda: tcommon.BatchNorm1d(C), 7).train()
    jm = jcommon.BatchNorm1d()
    sd = {k: v.copy() for k, v in sd_numpy(tm).items()}
    v = {"params": {"BatchNorm_0": {"scale": sd["weight"], "bias": sd["bias"]}},
         "batch_stats": {"BatchNorm_0": {"mean": sd["running_mean"],
                                         "var": sd["running_var"]}}}
    for x in xs:
        yt = tm(torch.tensor(x))
        yj, mut = jm.apply(v, x.transpose(0, 2, 1), train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        agree(yt, np.asarray(yj).transpose(0, 2, 1), 1e-5, "BatchNorm output")
    agree(tm.running_mean, v["batch_stats"]["BatchNorm_0"]["mean"], 1e-5, "running_mean")
    agree(tm.running_var, v["batch_stats"]["BatchNorm_0"]["var"], 1e-5, "running_var")
    ref, ours = torch.nn.BatchNorm1d(C).train(), tcommon.BatchNorm1d(C).train()
    if B * T == 1:
        with pytest.raises(ValueError):
            ref(torch.tensor(xs[0]))
    else:
        ref(torch.tensor(xs[0]))
        ours(torch.tensor(xs[0]))
        n = B * T  # torch's running variance is the unbiased one: n / (n - 1)
        agree((ref.running_var - 0.9) * (n - 1) / n, (ours.running_var - 0.9).numpy(),
              1e-6, "unbiased vs biased")


@pytest.mark.parametrize("B", [1, 2])
def test_global_latent_map_train_matches_flax(B):
    """GlobalLatentMap normalizes [B, L, 1]: its statistics run over B alone."""
    rng = np.random.RandomState(8)
    L, H = 8, 32
    z = rng.randn(B, 1, L).astype(np.float32)
    style = np.repeat(rng.randn(B, 1, H).astype(np.float32), 10, axis=1)
    tm = seeded(lambda: tfvae.GlobalLatentMap(L, H), 8).train()
    yt = tm(torch.tensor(z).transpose(1, 2), torch.tensor(style).transpose(1, 2))
    params, stats = t2j.convert_global_latent_map(_prefixed(sd_numpy(seeded(
        lambda: tfvae.GlobalLatentMap(L, H), 8))), "m")
    jm = jfvae.GlobalLatentMap(L)
    v = flax_load(jm, (z, style), {}, params, stats)
    yj, mut = jm.apply(v, z, style, train=True, mutable=["batch_stats"])
    agree(yt.transpose(1, 2), yj, 1e-5, "GlobalLatentMap (train)")
    if B == 1:
        assert torch.isfinite(yt).all()
    _, got = t2j.convert_global_latent_map(_prefixed(sd_numpy(tm)), "m")
    jax.tree_util.tree_map(lambda a, b: agree(np.asarray(a), b, 1e-5, "running stats"),
                           got, jax.device_get(mut["batch_stats"]))


def test_conformer_collate_length_matches_jax():
    """exact_lengths=False: one legacy table of the padded length and the
    plain rel-shift, on a padded batch."""
    rng = np.random.RandomState(9)
    H, T = 32, 40
    x = rng.randn(2, T, H).astype(np.float32)
    x *= (np.arange(T)[None, :] < np.asarray([40, 27])[:, None])[:, :, None]
    tm = seeded(lambda: tconf.ConformerLayers(H, 2, kernel_size=31, num_heads=4,
                                              use_last_norm=False))
    with torch.no_grad():
        yt = tm(torch.tensor(x), exact_lengths=False)
        ye = tm(torch.tensor(x), exact_lengths=True)
    params, stats = t2j.convert_conformer(_prefixed(sd_numpy(tm)), "m", 2)
    jm = jconf.ConformerLayers(H, 2, kernel_size=31, num_heads=4, use_last_norm=False)
    v = flax_load(jm, (x,), {}, params, stats)
    agree(yt, jm.apply(v, x, exact_lengths=False), 1e-4, "ConformerLayers (collate)")
    assert float((yt - ye).abs().max()) > 1e-3  # the two modes differ when padded
    pe = tconf.rel_positional_encoding(T, H)
    agree(torch.tensor(pe), jconf.rel_positional_encoding(T, H), 0.0, "table")


def test_vcasr_collate_length_matches_jax():
    mel = _mels(10, T=64, lens=(64, 44))
    tm = seeded(lambda: tasr.VCASR(20, 32, 1, (2, 1, 1), asr_last_norm=False), 1)
    with torch.no_grad():
        yt = tm(torch.tensor(mel).transpose(1, 2), exact_lengths=False)["h_content"]
    params, stats = t2j.convert_vcasr(_prefixed(sd_numpy(tm)), "m", 1, 1)
    jm = jasr.VCASR(20, 32, 1, 1, (2, 1, 1), asr_last_norm=False)
    v = flax_load(jm, (mel,), {}, params, stats)
    agree(yt.transpose(1, 2), jm.apply(v, mel, exact_lengths=False)["h_content"], 1e-4,
          "VCASR h_content (collate)")
