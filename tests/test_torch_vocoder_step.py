"""Vocoder training on the PyTorch port against the JAX package's
``neuralsvb_tpu/tasks/vocoder_task.py``: ``VocoderDataset`` crops and
batches bit for bit, and one generator step and one discriminator step of
``HifiGanTask`` from identical weights (``hifigan_from_jax``,
``mpd_from_jax``, ``msd_from_jax``) at the widths of the JAX package's own
``tests/test_tasks2.py`` vocoder test (rates 8,4,4, 16 channels, one
ResBlock1 kernel), ``max_samples`` 2048, no feature matching (the recipe's
setting; ``test_torch_vocoder_ops.py`` holds ``feature_loss`` and its input
gradient).

The batch holds a zero-padded crop: with flax's zero biases, zero mel and
zero f0 keep the generator and the discriminators at exactly 0 over the
padded stretch, where ``jax.nn.leaky_relu``'s derivative is 1. Both sides
draw no NSF noise (the port's ``zero_noise``, ``jax_zero_noise`` in JAX),
and the f0 of the data keeps the NSF phase exact in float32 (see
``write_vocoder_split``): at random init the gradient is discontinuous in
the source (leaky-ReLU units near 0 switch slope), and a sine that differs
by the rounding of another cumsum order moves gradients by about 1%. For
the same reason the L1 feature-matching loss is left out here: at the
edge of the padded stretch it compares near-equal tiny feature maps, whose
sign flips with rounding.
Checked: the losses (1e-4 relative), each gradient before clipping (max|d|
<= 1e-3 of the tensor's scale, ``_scales``) and the parameters after the
Adam step (a share of the learning rate, as ``test_torch_train_step.py``
holds the SVB steps)."""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import jax_zero_noise  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import (hifigan_from_jax, mpd_from_jax,  # noqa: E402
                                               msd_from_jax)
from neuralsvb_torch.data.indexed_dataset import IndexedDatasetBuilder  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

HOP = 128
# the JAX package's vocoder-task widths (tests/test_tasks2.py) and the
# recipe's audio settings (hifigan_nsf.yaml)
HP = dict(audio_sample_rate=22050, fft_size=512, hop_size=HOP, win_size=512, fmin=50,
          fmax=11025, audio_num_mel_bins=80, upsample_rates=[8, 4, 4],
          upsample_kernel_sizes=[16, 8, 8], upsample_initial_channel=16, resblock="1",
          resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], use_pitch_embed=True,
          max_samples=2048, max_sentences=2, lambda_mel=5.0, lambda_adv=1.0,
          use_fm_loss=False, adam_b1=0.8, adam_b2=0.99, disc_start_steps=0,
          generator_grad_norm=10, discriminator_grad_norm=1,
          generator_optimizer_params={"lr": 2e-4},
          generator_scheduler_params={"step_size": 600, "gamma": 0.999},
          discriminator_optimizer_params={"lr": 2e-4},
          discriminator_scheduler_params={"step_size": 600, "gamma": 0.999},
          seed=1234, train_set_name="train", valid_set_name="valid", endless_ds=True,
          ds_workers=0, mesh_shape="data:1", device="cpu", zero_noise=True)
# frames per item; the crop is 16 frames: shorter, equal, longer; item 3
# has no f0 and a wav half a hop longer than its mel
FRAMES = (10, 40, 16, 23, 64, 12)
STEP = 5
PARAM_TOL = 0.02  # parameters after Adam's first step: a share of lr


def write_vocoder_split(data_dir, frames, prefix, seed):
    """A packed split of sung-vibrato items with the keys the vocoder reads
    (``wav``, ``mel``, ``f0``)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    b = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    for i, T in enumerate(frames):
        n = T * HOP + (HOP // 2 if i == 3 else 0)
        t = np.arange(n) / 22050.0
        # f0 / sample rate on a grid of 1/1024: every phase increment and
        # every partial sum of the NSF source is exact in float32, so JAX's
        # cumsum and torch's agree bit for bit whatever their order
        f_hz = 22050 * rng.randint(8, 15) / 1024
        wav = 0.3 * np.sin(2 * np.pi * f_hz * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
        wav = (wav + 0.01 * rng.randn(n)).astype(np.float32)
        item = {"item_name": f"{prefix}_{i}", "wav": wav,
                "mel": (rng.randn(T, 80) - 4).astype(np.float32)}
        if i != 3:
            f0 = np.full(T, f_hz)
            f0[T // 3: T // 2] = 0.0
            item["f0"] = f0
        b.add_item(item)
    b.finalize()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder_data")
    write_vocoder_split(str(root), FRAMES, "train", 1)
    write_vocoder_split(str(root), FRAMES[:3], "valid", 2)
    return str(root)


def _datasets(hp):
    from neuralsvb_tpu.tasks.vocoder_task import VocoderDataset as JDataset
    from neuralsvb_torch.tasks.vocoder_task import VocoderDataset as TDataset
    jhparams.clear()
    jhparams.update(hp)
    return JDataset, TDataset


@pytest.mark.parametrize("shuffle", [True, False])
def test_dataset_matches_jax_bit_for_bit(data, shuffle):
    hp = dict(HP, binary_data_dir=data)
    JDataset, TDataset = _datasets(hp)
    prefix = "train" if shuffle else "valid"
    with hparams_scope(hp):
        jd, td = JDataset(prefix, shuffle), TDataset(prefix, shuffle)
        for _ in range(2):  # the shared RandomState moves on: a second pass differs
            order = td.ordered_indices()
            assert np.array_equal(order, jd.ordered_indices())
            items = [(td[int(i)], jd[int(i)]) for i in order]
            for t, j in items:
                assert t.keys() == j.keys()
                for k in t:
                    assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
                assert t["wav"].shape == (2048,) and t["mel"].shape == (16, 80)
            tb = td.collater([t for t, _ in items[:2]])
            jb = jd.collater([j for _, j in items[:2]])
            assert tb.keys() == jb.keys() and tb["nsamples"] == jb["nsamples"] == 2
            for k in ("wavs", "mels", "f0"):
                assert np.array_equal(tb[k], jb[k]), k


def _capture():
    """A first link of an optax chain that keeps the raw gradients."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


def _torch_names(params, mpd, msd):
    out = {f"gen.{k}": v.numpy() for k, v in hifigan_from_jax(params).items()}
    out.update({f"mpd.{k}": v.numpy() for k, v in mpd_from_jax(mpd).items()})
    out.update({f"msd.{k}": v.numpy() for k, v in msd_from_jax(msd).items()})
    return out


def _scales(want, names):
    """Per tensor: max|g_jax|, but at least 1e-3 of the group's largest."""
    floor = 1e-3 * max(float(np.abs(want[n]).max()) for n in names)
    return {n: max(float(np.abs(want[n]).max()), floor) for n in names}


def test_steps_match_jax(data):
    from neuralsvb_tpu.tasks.vocoder_task import HifiGanTask as JTask
    from neuralsvb_torch.tasks.vocoder_task import HifiGanTask as TTask
    from neuralsvb_torch.tasks.vocoder_task import VocoderDataset
    hp = dict(HP, binary_data_dir=data)
    jhparams.clear()
    jhparams.update(hp)
    jtask = JTask()
    jtask.build_model()
    jtask.tx_gen = optax.chain(_capture(), jtask.tx_gen)
    jtask.tx_disc = optax.chain(_capture(), jtask.tx_disc)
    st0 = jax.device_get(jtask.state)
    st0["opt_gen"] = jtask.tx_gen.init(st0["params"])
    st0["opt_disc"] = jtask.tx_disc.init({"mpd": st0["mpd"], "msd": st0["msd"]})
    jtask.set_state(st0)

    with hparams_scope(hp):
        ds = VocoderDataset("train")
        batch = ds.collater([ds[0], ds[4]])  # 10 of 16 frames (zero-padded), a crop of 64
        task = TTask()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(hifigan_from_jax(st0["params"]))
        task.mpd.load_state_dict(mpd_from_jax(st0["mpd"]))
        task.msd.load_state_dict(msd_from_jax(st0["msd"]))
        grads = {}
        task.grad_hook = lambda name, params: grads.__setitem__(
            name, [p.grad.detach().clone() for p in params])
        t_gen = task.training_step(batch, STEP, 0)
        t_disc = task.training_step(batch, STEP, 1)
    with jax_zero_noise():
        j_gen = jtask.training_step(batch, STEP, 0)
        j_disc = jtask.training_step(batch, STEP, 1)
    st = jax.device_get(jtask.state)
    assert not batch["wavs"][0, 10 * HOP:].any() and batch["wavs"][1].any()

    for (_, got), (_, want) in ((t_gen, j_gen), (t_disc, j_disc)):
        got = {k: float(v) for k, v in got.items() if not k.startswith("lr_")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
    assert set(t_gen[1]) == {"mel", "a_p", "a_s", "lr_0"}

    names = {"gen": [f"gen.{n}" for n, _ in task.model.named_parameters()],
             "disc": [f"mpd.{n}" for n, _ in task.mpd.named_parameters()]
             + [f"msd.{n}" for n, _ in task.msd.named_parameters()]}
    want = _torch_names(st["opt_gen"][0]["g"], st["opt_disc"][0]["g"]["mpd"],
                        st["opt_disc"][0]["g"]["msd"])
    settled = {}
    for group in ("gen", "disc"):
        scales = _scales(want, names[group])
        for n, g in zip(names[group], grads[group]):
            d = float(np.abs(g.numpy() - want[n]).max())
            assert d <= 1e-3 * scales[n], f"{n}: max|d| {d:.3e} vs scale {scales[n]:.3e}"
            settled[n] = np.abs(want[n]) > 2e-3 * scales[n]

    # parameters after the update: Adam's first step moves each by about
    # lr x sign(g), so an element whose gradient is within the tolerance of
    # zero may move either way (held to 2 lr)
    lr = float(t_gen[1]["lr_0"])
    after = _torch_names(st["params"], st["mpd"], st["msd"])
    port = {f"gen.{k}": v for k, v in task.model.state_dict().items()}
    port.update({f"mpd.{k}": v for k, v in task.mpd.state_dict().items()})
    port.update({f"msd.{k}": v for k, v in task.msd.state_dict().items()})
    for k, v in port.items():
        d = np.abs(v.numpy() - after[k])
        tol = np.where(settled[k], PARAM_TOL * lr + 1e-6, 2 * lr + 1e-6)
        assert (d <= tol).all(), f"{k}: max|d| {float(d.max()):.3e}"
    before = _torch_names(st0["params"], st0["mpd"], st0["msd"])
    assert all(not np.array_equal(port[k].numpy(), before[k]) for k in ("gen.conv_pre.weight",
                                                                        "mpd.discriminators.0.conv_post.weight"))
