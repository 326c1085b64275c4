"""Gradient accumulation (``accumulate_grad_batches: 2``, the port's
``training/optim.py`` ``MultiSteps``) against the JAX package's
``optax.MultiSteps`` (JAX test: ``tests/test_accum.py``).

Two different batches go through two micro-steps of each optimizer of a
step kind, on the port and on the JAX task from identical weights, with
nothing drawn at random (zero noise, all-keep dropout, windows at 0, as in
``tests/test_torch_train_step.py``):

- the flagship's phase 2 (generator and discriminator, steps 1 and 2) and
  phase 3 (the latent map, steps 101 and 102);
- ``VCPPGTask``'s generator and discriminator (steps 1 and 2).

After micro-step 1 the parameters and the optimizers' states are bit for
bit the initial ones, and the BatchNorm statistics have moved (they are not
optimizer state). After micro-step 2 the losses of both micro-steps match
the JAX task's at 1e-4 relative, the parameters and BatchNorm statistics at
the train-step tolerances (``PARAM_TOL`` x lr where the averaged gradient's
sign is settled, 2 lr where it is rounding), Adam's first moment within
1e-3 (1 - b1) of the averaged gradient's scale, and both sides' accumulators
are back at micro-step 0. A training run stopped in the middle of an
accumulation resumes exactly (the accumulators are in the checkpoint).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

from tests import test_torch_train_step as svb_step  # noqa: E402
from tests import test_torch_vcppg_step as vc_step  # noqa: E402
from tests.test_torch_ddp import _jax_mu  # noqa: E402
from tests.test_torch_support import one_torch_thread  # noqa: E402,F401
from tests.test_torch_train_e2e import _changed, root  # noqa: E402,F401

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import (disc_from_jax, svbvae_mle_from_jax,  # noqa: E402
                                               vcppg_from_jax)
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 2
PHASES = {"gen_disc": [(1, (0, 1)), (2, (0, 1))], "map": [(101, (2,)), (102, (2,))]}


def _state(task):
    return {k: v.detach().clone() for m in (task.model, task.mel_disc)
            for k, v in m.state_dict().items()}


def _opt_states(task, opts):
    return [{i: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
             for i, st in o.state_dict()["state"].items()} for o in opts]


def _mean_grads(grads, group):
    """The running mean optax.MultiSteps takes of the hooked micro-step
    gradients, and its settled elements (see ``_check_grads``)."""
    g1, g2 = grads[group]
    mean = [a + (b - a) / 2 for a, b in zip(g1, g2)]
    big = max(float(g.abs().max()) for g in mean)
    scales = [max(float(g.abs().max()), 1e-3 * big) for g in mean]
    return mean, scales


def _micro_steps(task, batches, plan, opts):
    """Run ``plan`` [(step, optimizer indices)] over ``batches``; returns
    the logs of each micro-step, and the model's state and the optimizers'
    states after the first."""
    logs, after_first, opt_first = [], None, None
    for n, ((step, idxs), batch) in enumerate(zip(plan, batches)):
        out = {}
        for i in idxs:
            ret = task.training_step(batch, step, i)
            if ret is not None:
                out.update(ret[1])
        logs.append(out)
        if n == 0:
            after_first, opt_first = _state(task), _opt_states(task, opts)
    return logs, after_first, opt_first


def _record(grads):
    """A grad hook keeping every micro-step's gradients per group."""
    return lambda group, params: grads.setdefault(group, []).append(
        [p.grad.detach().clone() for p in params])


@pytest.mark.parametrize("phase", list(PHASES))
def test_flagship_accumulates_as_multisteps(svb_step_fixture, phase):
    jtask, st0, hp = svb_step_fixture
    plan = PHASES[phase]
    batches = [svb_step._batch(), _other_batch()]
    with hparams_scope(hp):
        from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
        task = SVBVAEMleTask()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(svbvae_mle_from_jax(st0["params"], st0["batch_stats"]))
        task.mel_disc.load_state_dict(disc_from_jax(st0["disc_params"],
                                                    st0["disc_batch_stats"]))
        task.disc_start_frames_wins = [0, 0]
        grads = {}
        task.grad_hook = _record(grads)
        init = _state(task)
        opts = [task.opt_gen, task.opt_disc, task.opt_map]
        logs, first, opt_first = _micro_steps(task, batches, plan, opts)
    # micro-step 1: no update; the BatchNorm statistics of what ran moved
    groups = ("gen", "disc") if phase == "gen_disc" else ("map",)
    params = {n for m in (task.model, task.mel_disc) for n, _ in m.named_parameters()}
    assert all(torch.equal(first[k], init[k]) for k in params)
    assert opt_first == [{}, {}, {}]  # AdamW builds its state at its first step
    moved = {k for k in first if "running" in k and not torch.equal(first[k], init[k])}
    assert moved and (phase == "gen_disc" or all(
        k.startswith("z_mapping_function.") for k in moved)), sorted(moved)[:5]
    assert all(len(grads[g]) == K for g in groups)

    jtask.set_state(jax.tree_util.tree_map(np.array, st0))
    jtask._np_rng = np.random.RandomState(hp["seed"])
    jlogs = []
    for (step, idxs), batch in zip(plan, batches):
        out = {}
        for i in idxs:
            ret = jtask.training_step(batch, step, i)
            if ret is not None:
                out.update(ret[1])
        jlogs.append(out)
    st = jax.device_get(jtask.state)
    for n, (got, want) in enumerate(zip(logs, jlogs)):
        svb_step._check_losses(got, want, f"{phase} micro-step {n + 1}")

    names = svb_step._port_names(task)
    settled, lr = {}, 0.0
    mu_tree = {"gen": "opt_gen", "disc": "opt_disc", "map": "opt_map"}
    for group in groups:
        mean, scales = _mean_grads(grads, group)
        keys = names[group] if group != "disc" else [f"disc.{n}" for n in names["disc"]]
        for k, g, s in zip(keys, mean, scales):
            settled[k] = np.abs(g.numpy()) > 2e-3 * s
        lr = max(lr, float(logs[-1][f"lr_{('gen', 'disc', 'map').index(group)}"]))
        j = ("gen", "disc", "map").index(group)
        ms = st[mu_tree[group]]
        assert int(ms.mini_step) == 0 and task.accumulators[group].mini_step == 0
        mu = _jax_mu(ms.inner_opt_state)
        if group == "disc":
            want = svb_step._to_torch_names(st0, disc_params=mu)
        else:
            want = svb_step._to_torch_names(st0, params=dict(st0["params"], **mu))
        b1 = hp["optimizer_adam_beta1"]
        for i, (k, s) in enumerate(zip(keys, scales)):
            got = opts[j].state[opts[j].param_groups[0]["params"][i]]["exp_avg"].numpy()
            d = float(np.abs(got - want[k]).max())
            assert d <= 1e-3 * (1 - b1) * s, f"{group} mu {k}: {d:.3e} vs {s:.3e}"
    svb_step._check_state(task, st, lr, settled, f"{phase} after micro-step 2")


def _other_batch():
    b = svb_step._batch()
    rng = np.random.RandomState(7)
    for k in ("mels", "prof_mels"):
        b[k] = (b[k] + 0.5 * rng.randn(*b[k].shape) * (b[k] != 0)).astype(np.float32)
    b["multi_spk_emb"] = rng.randn(*b["multi_spk_emb"].shape).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def svb_step_fixture():
    """The JAX flagship with accumulate_grad_batches 2 at data:1, its
    initial state and the port's hparams; dropout keeps everything and the
    noise is zero on both sides for the module."""
    from neuralsvb_tpu.tasks.svb_vae_task import SVBVAEMleTask
    from tests.test_torch_ddp import _patched_jax
    from tests.test_torch_ddp_worker import all_keep_dropout
    hp = dict(svb_step.HP, accumulate_grad_batches=K)
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(hp)
    task = SVBVAEMleTask()
    task.build_model()
    task._np_rng = np.random.RandomState(hp["seed"])
    st0 = jax.device_get(task.state)
    restore = _patched_jax()
    try:
        with all_keep_dropout():
            yield task, st0, hp
    finally:
        restore()
        jhparams.clear()
        jhparams.update(saved)


def test_vcppg_accumulates_as_multisteps(patched_vc):
    hp = dict(patched_vc, accumulate_grad_batches=K)
    name = "vc_ppg.VCPPGTask"
    jtask, st0 = vc_step._jax_task(name, hp)
    batches = [vc_step._batch(1), vc_step._batch(2)]
    with hparams_scope(dict(hp)):
        task = vc_step._cls("neuralsvb_torch", name)()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(vcppg_from_jax(st0["params"], st0["batch_stats"]))
        task.mel_disc.load_state_dict(disc_from_jax(st0["disc_params"][""],
                                                    st0["disc_batch_stats"][""]))
        task.disc_start_frames_wins = [0, 0]
        grads = {}
        task.grad_hook = _record(grads)
        init = _state(task)
        plan = PHASES["gen_disc"]
        logs, first, opt_first = _micro_steps(task, batches, plan, (task.opt_gen, task.opt_disc))
    params = {n for m in (task.model, task.mel_disc) for n, _ in m.named_parameters()}
    assert all(torch.equal(first[k], init[k]) for k in params)
    assert opt_first == [{}, {}]
    moved = [k for k in first if "running" in k and not torch.equal(first[k], init[k])]
    assert moved  # the generator's BatchNorms (the ASR's stay on running statistics)
    assert not any(k.startswith("vc_asr.") for k in moved)

    jlogs = []
    for (step, idxs), batch in zip(plan, batches):
        out = {}
        for i in idxs:
            out.update(jtask.training_step(batch, step, i)[1])
        jlogs.append(out)
    st = jax.device_get(jtask.state)
    for n, (got, want) in enumerate(zip(logs, jlogs)):
        svb_step._check_losses(got, want, f"micro-step {n + 1}")
    names = {"gen": [n for n, _ in task.model.named_parameters()],
             "disc": [f"disc.{n}" for n, _ in task.mel_disc.named_parameters()]}
    settled = {}
    for group in ("gen", "disc"):
        mean, scales = _mean_grads(grads, group)
        for k, g, s in zip(names[group], mean, scales):
            settled[k] = np.abs(g.numpy()) > 2e-3 * s
        ms = st[f"opt_{group}"][1]  # behind the test's gradient capture
        assert int(ms.mini_step) == 0 and task.accumulators[group].mini_step == 0
    lr = max(float(logs[-1]["lr_0"]), float(logs[-1]["lr_1"]))
    vc_step._check_state(task, vc_step._torch_names(st), lr, settled, "after micro-step 2")


@pytest.fixture
def patched_vc(hp, patched):
    return hp


hp = vc_step.hp
patched = vc_step.patched


def _fit(root, work, max_updates):
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    from neuralsvb_torch.training.trainer import Trainer
    h = set_hparams(config=str(root / "cfg.yaml"),
                    hparams_str=f"device=cpu,work_dir={work},max_updates={max_updates},"
                                f"num_sanity_val_steps=0,num_valid_plots=0,"
                                f"accumulate_grad_batches={K}",
                    print_hparams=False, global_hparams=False)
    with hparams_scope(h) as h:
        Trainer.from_hparams(h).fit(SVBVAEMleTask())


def test_resume_in_the_middle_of_an_accumulation(root, tmp_path):
    """The generator's steps 0-1 accumulate one update: a run stopped after
    step 0 (its micro-step 1 of 2 saved; the discriminator starts after
    step 0) and resumed to step 2 ends where the uninterrupted run ends,
    accumulators included (the discriminator's in the middle of its own)."""
    _fit(root, tmp_path / "a", 2)
    _fit(root, tmp_path / "b", 1)
    mid = torch.load(tmp_path / "b" / "model_ckpt_steps_1.ckpt", weights_only=True)
    assert {g: a["mini_step"] for g, a in mid["accumulators"].items()} == \
        {"gen": 1, "disc": 0, "map": 0}
    _fit(root, tmp_path / "b", 2)
    a = torch.load(tmp_path / "a" / "model_ckpt_steps_2.ckpt", weights_only=True)
    b = torch.load(tmp_path / "b" / "model_ckpt_steps_2.ckpt", weights_only=True)
    assert a["accumulators"]["disc"]["mini_step"] == 1
    for part in ("model", "mel_disc"):
        assert not _changed(a["state_dict"][part], b["state_dict"][part]), part
    for oa, ob in zip(a["optimizer_states"], b["optimizer_states"]):
        for i, st in oa["state"].items():
            assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    for g, acc in a["accumulators"].items():
        assert acc["mini_step"] == b["accumulators"][g]["mini_step"]
        assert all(torch.equal(x, y) for x, y in zip(acc["acc"], b["accumulators"][g]["acc"]))
