"""One training step of each optimizer of the four other SVB tasks
(``SVBVAETechMleTask``, ``SVBVAESegTechMleTask``, ``SVBVAEBoostTask``,
``SVBVAETask``) on the PyTorch port vs the same task of the JAX package,
from identical weights (``svbvae_from_jax`` + ``disc_from_jax``) on one
padded batch, as ``tests/test_torch_train_step.py`` does for the flagship
and at its tolerances; ``SVBVAETask`` (``variant="local"``) at latent 16.

Nothing is drawn at random but the a2p sample of the global and local
variants: its noise is one fixed array on both sides, so the map step's
adversarial term reads ``m + eps * exp(logs)`` and its gradient reaches the
scale map. The technique-prior tasks' map step has no ``a2p_mle`` term, as
in the JAX package (its a2p way returns an ``mle`` where the step reads a
``kl``); the loss keys and the map's gradients show it.

A latent map's biases in front of its first training-mode BatchNorm
(``convs.0``'s, and in the 1x1 maps the style projection's last one) have
a gradient that is zero in exact arithmetic: the BatchNorm removes any
constant shift (the local map's k3 ``convs.0`` pads with zeros, so a shift
of its input is not constant at the edges). Each side's
value is rounding noise of the batch sum, and the JAX package's reaches
1.4e-6 of the group's largest gradient in the global variant, beyond the
flagship test's 1e-6 floor. They are held to zero on both sides (1e-5 of
the group's largest) instead of to each other."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_svb_variants import jax_injected_noise  # noqa: E402
from tests.test_torch_train_step import (B, GEN_STEP, HP, MAP_STEP, T,  # noqa: E402
                                         _batch, _capture, _check_grads, _check_losses,
                                         _check_state, _port_names, _to_torch_names)

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import disc_from_jax, svbvae_from_jax  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402
from neuralsvb_torch.models import svb_vae as tsvb  # noqa: E402

TASKS = {"tech_mle": "SVBVAETechMleTask", "seg_tech_mle": "SVBVAESegTechMleTask",
         "global": "SVBVAEBoostTask", "local": "SVBVAETask"}


def _hp(variant):
    return dict(HP, latent_size=16 if variant == "local" else HP["latent_size"])


def _check_map_grads(got, want, names, variant):
    """``_check_grads`` for the map group, with its structurally zero
    gradients held to rounding level on both sides."""
    ends = ("convs.0.bias",) if variant == "local" else ("convs.0.bias", "spk_proj.2.bias")
    big = max(float(np.abs(want[n]).max()) for n in names)
    zero = [(n, g) for n, g in zip(names, got) if n.endswith(ends)]
    assert zero
    for n, g in zero:
        worst = max(float(g.abs().max()), float(np.abs(want[n]).max()))
        assert worst <= 1e-5 * big, f"map grad {n}: {worst:.3e} vs {big:.3e}"
    rest = [(n, g) for n, g in zip(names, got) if not n.endswith(ends)]
    settled = _check_grads([g for _, g in rest], want, [n for n, _ in rest], "map")
    settled.update({n: np.zeros(want[n].shape, bool) for n, _ in zero})
    return settled


def _jax_task(variant):
    from neuralsvb_tpu.tasks import svb_vae_task as jt
    jhparams.clear()
    jhparams.update(_hp(variant))
    task = getattr(jt, TASKS[variant])()
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
    task.set_state(jax.tree_util.tree_map(np.array, st))
    task._np_rng = np.random.RandomState(HP["seed"])
    return task, st


def _port_task(variant, st):
    from neuralsvb_torch.tasks import svb_vae_task as tt
    task = getattr(tt, TASKS[variant])()
    task.build_model()
    task.build_train()
    task.model.load_state_dict(svbvae_from_jax(st["params"], st["batch_stats"], variant))
    task.mel_disc.load_state_dict(disc_from_jax(st["disc_params"], st["disc_batch_stats"]))
    task.disc_start_frames_wins = [0, 0]
    grads = {}
    task.grad_hook = lambda name, params: grads.__setitem__(
        name, [p.grad.detach().clone() for p in params])
    return task, grads


@pytest.fixture
def patched(monkeypatch):
    """All-keep dropout on both sides; zero noise on the JAX side, except
    where a test injects the a2p sample's."""
    saved = dict(jhparams)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    yield monkeypatch
    jhparams.clear()
    jhparams.update(saved)


@pytest.mark.parametrize("variant", list(TASKS))
def test_variant_steps_match_jax(patched, variant):
    batch = _batch()
    jtask, st0 = _jax_task(variant)
    maps = jtask._get_mapping_keys()
    sampled = variant in ("global", "local")
    Tz = 1 if variant == "global" else T // 4
    eps = np.random.RandomState(5).randn(B, Tz, _hp(variant)["latent_size"]).astype(np.float32)
    patched.setattr(tsvb, "draw_normal", lambda shape, like, generator, zero_noise:
                    torch.tensor(eps).transpose(1, 2).to(like))
    with hparams_scope(dict(_hp(variant), cache_ppg=False)):
        task, grads = _port_task(variant, st0)
        assert task.model.mapping_keys == maps
        names = _port_names(task)

        # phase 2: generator, then the discriminator on its detached fakes
        t_gen = task.training_step(batch, GEN_STEP, 0)
        t_disc = task.training_step(batch, GEN_STEP, 1)
        with jax_injected_noise(eps, 0):  # every draw zero
            j_gen = jtask.training_step(batch, GEN_STEP, 0)
            j_disc = jtask.training_step(batch, GEN_STEP, 1)
        st = jax.device_get(jtask.state)
        _check_losses(t_gen[1], j_gen[1], "gen")
        _check_losses(t_disc[1], j_disc[1], "disc")
        assert {"a2a_a", "p2p_a"} <= set(t_gen[1]) and {"a2a_r", "p2p_f"} <= set(t_disc[1])
        want = _to_torch_names(st0, params=st["opt_gen"][0]["g"],
                               disc_params=st["opt_disc"][0]["g"], variant=variant)
        settled = _check_grads(grads["gen"], want, names["gen"], "gen")
        settled.update({f"disc.{k}": v for k, v in _check_grads(
            grads["disc"], {k[5:]: v for k, v in want.items() if k.startswith("disc.")},
            names["disc"], "disc").items()})
        _check_state(task, st, max(j_gen[1]["lr_0"], j_disc[1]["lr_1"]), settled,
                     "after gen+disc", variant)
        if variant == "seg_tech_mle":  # the attention trains with the generator
            assert any(n.startswith("seg_ref_attn.") for n in names["gen"])
            assert any(n.startswith("k_mel_encoder_0.") for n in names["gen"])

        # phase 3: the latent maps alone
        before = {k: v.clone() for k, v in task.model.state_dict().items()}
        t_map = task.training_step(batch, MAP_STEP, 2)
        # the JAX map step draws a2a's, p2p's, then the a2p sample's noise
        with jax_injected_noise(eps, 3 if sampled else 0) as calls:
            j_map = jtask.training_step(batch, MAP_STEP, 2)
        assert len(calls) == 3 or not sampled, calls
        st = jax.device_get(jtask.state)
        _check_losses(t_map[1], j_map[1], "map")
        if sampled:
            assert "a2p_kl" in t_map[1] and "a2p_mle" not in t_map[1]
        else:  # trap: the technique-prior map step reads a "kl" a2p lacks
            assert "a2p_mle" not in t_map[1] and "a2p_kl" not in t_map[1]
        assert "a2p_a" in t_map[1]
        want = _to_torch_names(st0, params=dict(st["params"], **st["opt_map"][0]["g"]),
                               variant=variant)
        settled = _check_map_grads(grads["map"], want, names["map"], variant)
        _check_state(task, st, j_map[1]["lr_2"], settled, "after map", variant)
        changed = {k for k, v in task.model.state_dict().items()
                   if not torch.equal(v, before[k])}
        assert changed and all(k.startswith(maps) for k in changed), changed
        if sampled:  # the scale map moved through the sampled decode
            assert any(k.startswith("logs_mapping_function.") and "weight" in k
                       for k in changed)
