"""One training step of each optimizer on the PyTorch port vs the JAX
package's ``SVBVAEMleTask``, from identical weights (``svbvae_mle_from_jax``
+ ``disc_from_jax``) on one padded batch, at the tiny widths of
``tests/test_cycle.py`` (hidden 32, latent 8, FVAE 16/2/2, 1-layer ASR,
disc hidden 8, windows 32/64).

Both sides draw nothing at random: the posterior noise is zero (the port's
``zero_noise``, ``jax_zero_noise`` on the JAX side, which also makes every
JAX window start at 0, the port's pinned ``disc_start_frames_wins``) and the
discriminator's dropout keeps every element (the 1/0.75 scaling stays).

Step 1 runs the generator and the discriminator (phase 2, ways a2a,p2p);
step 101 (past ``phase_2_steps`` 100) the latent map. Checked per step: the
losses (1e-4 relative), the gradients of the optimizer's parameters before
clipping (per tensor max|d| <= 1e-3 max|g_jax|, see ``_scales``), the
parameters (see ``_check_state``) and BatchNorm statistics after the
update, and, in phase 3, that only
``z_mapping_function`` changes. Once with ``cache_ppg`` off (the frozen ASR
runs in the step at the collate-length rel-pos) and once on (content rows
computed per item at its exact length, as the port's cache does, and handed
to the JAX step as ``ppg_a``/``ppg_p``)."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tests.test_cycle import TINY  # noqa: E402
from tests.test_torch_support import jax_zero_noise  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import (disc_from_jax, svbvae_from_jax,  # noqa: E402
                                               svbvae_mle_from_jax)
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402

HP = dict(TINY, mesh_shape="data:1", wire_dtype="float32", device="cpu",
          zero_noise=True, max_frames=5000)
B, T = 3, 64
LENS_A, LENS_P = (64, 56, 40), (60, 64, 48)
GEN_STEP, MAP_STEP = 1, 101
# the batch's seed. With seed 0 one leaky-ReLU unit of the discriminator
# gets an input within rounding distance of 0 in the cache_ppg run (float
# sums run in another order on each side), takes the other slope on one
# side and moves the generator's gradients by up to 0.7%; seeds 1-3 have no
# such unit
BATCH_SEED = 1
# parameters after an update: Adam moves each one by about lr on its first
# step, so the bound is a share of the step's learning rate (gen 2.0e-6, disc
# 1e-4, map 1e-3 here), plus float rounding of the parameter itself
PARAM_TOL = 0.02


def _batch():
    rng = np.random.RandomState(BATCH_SEED)
    ma = (np.arange(T)[None] < np.asarray(LENS_A)[:, None])
    mp = (np.arange(T)[None] < np.asarray(LENS_P)[:, None])
    align = np.stack([np.sort(rng.randint(0, la, T)) for la in LENS_A]) * mp
    return dict(
        id=np.arange(B), nsamples=B,
        mels=((rng.randn(B, T, 80) - 2) * ma[..., None]).astype(np.float32),
        prof_mels=((rng.randn(B, T, 80) - 2) * mp[..., None]).astype(np.float32),
        pitch=(rng.randint(1, 255, (B, T)) * ma).astype(np.int64),
        prof_pitch=(rng.randint(1, 255, (B, T)) * mp).astype(np.int64),
        a2p_f0_alignment=align.astype(np.int64),
        multi_spk_emb=rng.randn(B, 5, 256).astype(np.float32))


def _capture():
    """A first link of an optax chain that keeps the raw gradients in its
    state, so the test reads them after the jitted step."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


@pytest.fixture(scope="module")
def jax_task():
    from neuralsvb_tpu.tasks.svb_vae_task import SVBVAEMleTask
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(HP)
    task = SVBVAEMleTask()
    task.build_model()
    task.tx_gen = optax.chain(_capture(), task.tx_gen)
    task.tx_disc = optax.chain(_capture(), task.tx_disc)
    task.tx_map = optax.chain(_capture(), task.tx_map)
    st = jax.device_get(task.state)
    params = st["params"]
    st["opt_gen"] = task.tx_gen.init({k: v for k, v in params.items()
                                      if task._gen_key_filter(k)})
    st["opt_disc"] = task.tx_disc.init(st["disc_params"])
    st["opt_map"] = task.tx_map.init({k: params[k] for k in task._get_mapping_keys()})
    yield task, jax.device_get(st)
    jhparams.clear()
    jhparams.update(saved)


@pytest.fixture
def patched(monkeypatch):
    """All-keep dropout on both sides; zero noise on the JAX side."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    jhparams.clear()
    jhparams.update(HP)
    with jax_zero_noise():
        yield


def _port_task(st, cache_ppg: bool, items):
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    task = SVBVAEMleTask()
    task.build_model()
    task.build_train()
    task.model.load_state_dict(svbvae_mle_from_jax(st["params"], st["batch_stats"]))
    task.mel_disc.load_state_dict(disc_from_jax(st["disc_params"], st["disc_batch_stats"]))
    task.disc_start_frames_wins = [0, 0]
    task._train_ds = items
    grads = {}
    task.grad_hook = lambda name, params: grads.__setitem__(
        name, [p.grad.detach().clone() for p in params])
    return task, grads


def _jax_ppg_rows(task, st, batch):
    """The JAX extractor on each item alone at its exact length, collated."""
    from neuralsvb_tpu.models.svb_vae import SVBVAE
    var = {"params": {"vc_asr": st["params"]["vc_asr"]},
           "batch_stats": {"vc_asr": st["batch_stats"]["vc_asr"]}}
    out = {}
    for key, lens, name in (("mels", LENS_A, "ppg_a"), ("prof_mels", LENS_P, "ppg_p")):
        rows = np.zeros((B, T // 2, HP["hidden_size"]), np.float32)
        for i, n in enumerate(lens):
            r = task.model.apply(var, batch[key][i: i + 1, :n], method=SVBVAE.extract_ppg)
            rows[i, : r.shape[1]] = np.asarray(r[0])
        out[name] = rows
    return out


class _Items:
    """The batch's items unpadded, as the port's PPG cache reads them."""

    def __init__(self, batch):
        self.items = [{"id": i, "mel": batch["mels"][i, :la],
                       "prof_mel": batch["prof_mels"][i, :lp]}
                      for i, (la, lp) in enumerate(zip(LENS_A, LENS_P))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _port_names(task):
    model = dict(task.model.named_parameters())
    return {"gen": [n for n, p in model.items() if any(p is q for q in task.gen_params)],
            "map": [n for n, p in model.items() if any(p is q for q in task.map_params)],
            "disc": [n for n, _ in task.mel_disc.named_parameters()]}


def _to_torch_names(st, params=None, disc_params=None, variant="mle"):
    """A JAX state (or a gradient tree in place of its params) of the SVB
    VAE ``variant`` under the port's names."""
    p = dict(st["params"], **(params or {}))
    out = {k: v.numpy() for k, v in svbvae_from_jax(p, st["batch_stats"], variant).items()}
    out.update({f"disc.{k}": v.numpy() for k, v in disc_from_jax(
        disc_params if disc_params is not None else st["disc_params"],
        st["disc_batch_stats"]).items()})
    return out


def _scales(want, names):
    """Per tensor, the gradient scale of the checks: max|g_jax|, but at least
    1e-3 of the group's largest. A gradient that is zero in exact arithmetic
    (a bias whose shift a training-mode BatchNorm removes) is rounding noise
    on both sides."""
    floor = 1e-3 * max(float(np.abs(want[n]).max()) for n in names)
    return {n: max(float(np.abs(want[n]).max()), floor) for n in names}


def _check_grads(got, want, names, what):
    """Per tensor max|d| <= 1e-3 of its scale; returns, per tensor, the
    elements whose gradient lies beyond that tolerance of zero on both
    sides (their update's sign is settled)."""
    settled = {}
    for n, g in zip(names, got):
        scale = _scales(want, names)[n]
        d = float(np.abs(g.numpy() - want[n]).max())
        assert d <= 1e-3 * scale, \
            f"{what} grad {n}: max|d| {d:.3e} vs scale {scale:.3e}"
        settled[n] = np.abs(want[n]) > 2e-3 * scale
    return settled


def _check_losses(got, want, what):
    got = {k: float(v) for k, v in got.items() if not k.startswith("lr_")}
    want = {k: float(v) for k, v in want.items() if not k.startswith("lr_")}
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{what} loss {k}")


def _check_state(task, st, lr, settled, what, variant="mle"):
    """BatchNorm running statistics within 1e-5; parameters within
    PARAM_TOL x lr (+1e-6) of the JAX update. Adam's first update is about
    lr x sign(g), so an element whose gradient is within the gradient
    tolerance of zero may move either way: it is held to 2 lr."""
    want = _to_torch_names(st, variant=variant)
    port = {k: v.detach().numpy() for k, v in task.model.state_dict().items()}
    port.update({f"disc.{k}": v.detach().numpy()
                 for k, v in task.mel_disc.state_dict().items()})
    for k, v in port.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(v - want[k])
        if "running" in k:
            assert float(d.max()) <= 1e-5, f"{what}: {k} max|d| {float(d.max()):.3e}"
            continue
        ok = settled.get(k, np.ones(d.shape, bool))
        tol = np.where(ok, PARAM_TOL * lr + 1e-6, 2 * lr + 1e-6)
        assert (d <= tol).all(), f"{what}: {k} max|d| {float(d.max()):.3e}"


@pytest.mark.parametrize("cache_ppg", [False, True])
def test_steps_match_jax(jax_task, patched, cache_ppg):
    jtask, st0 = jax_task
    batch = _batch()
    jtask.set_state(jax.tree_util.tree_map(np.array, st0))
    jtask._np_rng = np.random.RandomState(HP["seed"])
    if cache_ppg:
        rows = _jax_ppg_rows(jtask, st0, batch)
        host = type(jtask)._prep_batch_host
        jtask._prep_batch_host = lambda b, infer=False: dict(host(jtask, b, infer), **rows)
    else:
        jtask.__dict__.pop("_prep_batch_host", None)
    with hparams_scope(dict(HP, cache_ppg=cache_ppg)):
        task, grads = _port_task(st0, cache_ppg, _Items(batch))
        names = _port_names(task)

        # phase 2: generator, then the discriminator on its detached fakes
        t_gen = task.training_step(batch, GEN_STEP, 0)
        t_disc = task.training_step(batch, GEN_STEP, 1)
        j_gen = jtask.training_step(batch, GEN_STEP, 0)
        j_disc = jtask.training_step(batch, GEN_STEP, 1)
        st = jax.device_get(jtask.state)
        _check_losses(t_gen[1], j_gen[1], "gen")
        _check_losses(t_disc[1], j_disc[1], "disc")
        assert {"a2a_a", "p2p_a"} <= set(t_gen[1]) and {"a2a_r", "p2p_f"} <= set(t_disc[1])
        assert task.training_step(batch, GEN_STEP, 2) is None
        want = _to_torch_names(st0, params=st["opt_gen"][0]["g"],
                               disc_params=st["opt_disc"][0]["g"])
        settled = _check_grads(grads["gen"], want, names["gen"], "gen")
        settled.update({f"disc.{k}": v for k, v in _check_grads(
            grads["disc"], {k[5:]: v for k, v in want.items() if k.startswith("disc.")},
            names["disc"], "disc").items()})
        _check_state(task, st, max(j_gen[1]["lr_0"], j_disc[1]["lr_1"]), settled,
                     "after gen+disc")

        # phase 3: the latent map alone
        before = {k: v.clone() for k, v in task.model.state_dict().items()}
        disc_before = {k: v.clone() for k, v in task.mel_disc.state_dict().items()}
        assert task.training_step(batch, MAP_STEP, 0) is None
        assert task.training_step(batch, MAP_STEP, 1) is None
        t_map = task.training_step(batch, MAP_STEP, 2)
        j_map = jtask.training_step(batch, MAP_STEP, 2)
        st = jax.device_get(jtask.state)
        _check_losses(t_map[1], j_map[1], "map")
        assert "a2p_mle" in t_map[1] and "a2p_a" in t_map[1]
        want = _to_torch_names(st0, params=dict(st["params"], **st["opt_map"][0]["g"]))
        settled = _check_grads(grads["map"], want, names["map"], "map")
        _check_state(task, st, j_map[1]["lr_2"], settled, "after map")
        changed = {k for k, v in task.model.state_dict().items()
                   if not torch.equal(v, before[k])}
        assert changed and all(k.startswith("z_mapping_function.") for k in changed), changed
        assert all(torch.equal(v, disc_before[k]) for k, v in task.mel_disc.state_dict().items())
