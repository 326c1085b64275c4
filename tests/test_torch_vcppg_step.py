"""One generator and one discriminator step of ``VCPPGTask``,
``SVBParaTask``, ``SVBPPGTask`` and the six subclasses of ``SVBParaTask``
(the PPG constraint, pre-expansion, aligned ASR, frozen pretrained ASR,
speaker consistency with its second discriminator, amateur speaker) on the
PyTorch port vs the same task of the JAX package, from identical weights
(``vcppg_from_jax`` + ``discs_from_jax``) on one padded batch with phone
tokens, at tiny widths of the ``vc_ppg.yaml`` recipe (hidden 32, one
conformer and one ASR decoder layer, two decoder conv layers, disc hidden
8, windows 32/64). ``AmtSpkTask`` runs with ``ref_enc_out: 256`` and
``use_energy: false``, the only settings its JAX task runs with.

Nothing is drawn at random: every window of the discriminator starts at 0
(``jax_zero_noise`` on the JAX side, pinned windows on the port's) and
every dropout mask keeps every element (the 1/(1-p) scaling stays), the
decoder's (p 0.05) and the discriminator's. The discriminator is on from
step 1 (``disc_start_steps`` 0). Checked, at the flagship step test's
tolerances (``tests/test_torch_train_step.py``): the losses (1e-4
relative), the gradients before clipping (per tensor max|d| <= 1e-3 of its
scale), the parameters and the BatchNorm statistics after each update. The
ASR trains through the CE loss alone: its PPG into the decoder carries no
gradient, and its BatchNorms stay on their running statistics; the three
pretrained tasks leave it out of the optimizer and compute no CE in
training."""

from __future__ import annotations

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import jax_zero_noise, one_torch_thread  # noqa: E402,F401
from tests.test_torch_train_step import (PARAM_TOL, _capture, _check_grads,  # noqa: E402
                                         _check_losses)

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import discs_from_jax, vcppg_from_jax  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, load_config_recursive  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=32, asr_enc_layers=1, asr_dec_layers=1, dec_layers=2,
            ref_enc_out=32, mel_disc_hidden_size=8, disc_win_num=2, mesh_shape="data:1",
            wire_dtype="float32", device="cpu", max_frames=5000, seed=1234)
B, T, L = 3, 64, 12
LENS_A, LENS_P, TOK_LENS = (64, 56, 40), (60, 64, 48), (12, 9, 7)
N_PHONES = 30
STEP = 1
TASKS = ("vc_ppg.VCPPGTask", "svb_para.SVBParaTask", "svb_ppg.SVBPPGTask",
         "svb_para.ParaPPGConstraintTask", "svb_para.ParaPPGPreExpTask",
         "svb_para.ParaAlignedPPGTask", "svb_para.ParaPPGPretrainedTask",
         "svb_para.ParaPPGSpkConsistentTask", "svb_para.AmtSpkTask")
PRETRAINED = ("ParaPPGPretrainedTask", "ParaPPGSpkConsistentTask", "AmtSpkTask")
TASK_HP = {"svb_para.AmtSpkTask": dict(ref_enc_out=256, use_energy=False)}


@pytest.fixture(scope="module")
def hp(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppg_bin")
    (d / "phone_set.json").write_text(
        "[" + ",".join(f'"p{i}"' for i in range(N_PHONES)) + "]")
    cfg = load_config_recursive(os.path.join(REPO, "egs/egs_bases/vc/vc_ppg.yaml"))
    return dict(cfg, **TINY, binary_data_dir=str(d))


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    ma = np.arange(T)[None] < np.asarray(LENS_A)[:, None]
    mp = np.arange(T)[None] < np.asarray(LENS_P)[:, None]
    mt = np.arange(L)[None] < np.asarray(TOK_LENS)[:, None]
    mels = ((rng.randn(B, T, 80) - 2) * ma[..., None]).astype(np.float32)
    prof = ((rng.randn(B, T, 80) - 2) * mp[..., None]).astype(np.float32)
    return dict(
        id=np.arange(B), nsamples=B, mels=mels, prof_mels=prof,
        pitch=(rng.randint(1, 255, (B, T)) * ma).astype(np.int64),
        prof_pitch=(rng.randint(1, 255, (B, T)) * mp).astype(np.int64),
        energy=(np.sqrt((np.exp(mels) ** 2).sum(-1)) * ma).astype(np.float32),
        prof_energy=(np.sqrt((np.exp(prof) ** 2).sum(-1)) * mp).astype(np.float32),
        a2p_f0_alignment=(np.stack([np.sort(rng.randint(0, n, T)) for n in LENS_A])
                          * mp).astype(np.int64),
        multi_spk_emb=rng.randn(B, 5, 256).astype(np.float32),
        txt_tokens=(rng.randint(4, N_PHONES + 4, (B, L)) * mt).astype(np.int64))


class _ProfSide:
    """A random stream whose every ``randint`` picks the professional side."""

    @staticmethod
    def randint(lo, hi):
        return 1


def _cls(pkg, name):
    import importlib
    mod, cls = name.rsplit(".", 1)
    return getattr(importlib.import_module(f"{pkg}.tasks.{mod}"), cls)


@pytest.fixture
def patched(monkeypatch):
    """All-keep dropout on both sides; window starts at 0 on the JAX side."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    with jax_zero_noise():
        yield


def _jax_task(name, hp):
    jhparams.clear()
    jhparams.update(hp)
    task = _cls("neuralsvb_tpu", name)()
    task.build_model()
    task.tx_gen = optax.chain(_capture(), task.tx_gen)
    task.tx_disc = optax.chain(_capture(), task.tx_disc)
    st = jax.device_get(task.state)
    st["opt_gen"] = task.tx_gen.init({k: v for k, v in st["params"].items()
                                      if k not in task.frozen_keys()})
    st["opt_disc"] = task.tx_disc.init(st["disc_params"])
    task.set_state(st)
    return task, jax.device_get(st)


def _torch_names(st, params=None, disc_params=None):
    """A JAX state (or gradient trees in place of its params; a frozen
    subtree missing from them reads as the state's) under the port's
    names; discriminator ``dname``'s under ``disc{dname}.``."""
    params = dict(st["params"], **(params or {}))
    out = {k: v.numpy() for k, v in vcppg_from_jax(params, st["batch_stats"]).items()}
    for dname, sd in discs_from_jax(disc_params or st["disc_params"],
                                    st["disc_batch_stats"]).items():
        out.update({f"disc{dname}.{k}": v.numpy() for k, v in sd.items()})
    return out


def _check_state(task, want, lr, settled, what):
    """BatchNorm statistics within 1e-5; parameters within PARAM_TOL x lr
    (+1e-6) of the JAX update (2 lr where the gradient's sign is within its
    tolerance of zero: Adam's first step is about lr x sign(g))."""
    port = {k: v.detach().numpy() for k, v in task.model.state_dict().items()}
    for dname, d in task.discriminators.items():
        port.update({f"disc{dname}.{k}": v.detach().numpy()
                     for k, v in d.state_dict().items()})
    for k, v in port.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(v - want[k])
        if "running" in k:
            assert float(d.max()) <= 1e-5, f"{what}: {k} max|d| {float(d.max()):.3e}"
            continue
        tol = np.where(settled.get(k, np.ones(d.shape, bool)), PARAM_TOL * lr + 1e-6,
                       2 * lr + 1e-6)
        assert (d <= tol).all(), f"{what}: {k} max|d| {float(d.max()):.3e}"


@pytest.mark.parametrize("name", TASKS)
def test_steps_match_jax(hp, patched, name):
    hp = dict(hp, **TASK_HP.get(name, {}))
    batch = _batch()
    jtask, st0 = _jax_task(name, hp)
    if name.endswith("SVBPPGTask"):
        # the technique prefix: the professional side on both
        jtask._np_rng = _ProfSide()
    with hparams_scope(dict(hp)):
        task = _cls("neuralsvb_torch", name)()
        task.build_model()
        task.build_train()
        task.model.load_state_dict(vcppg_from_jax(st0["params"], st0["batch_stats"]))
        discs = discs_from_jax(st0["disc_params"], st0["disc_batch_stats"])
        assert discs.keys() == task.discriminators.keys()
        for dname, d in task.discriminators.items():
            d.load_state_dict(discs[dname])
        task.disc_start_frames_wins = [0, 0]
        if name.endswith("SVBPPGTask"):
            task._np_rng = _ProfSide()
        grads = {}
        task.grad_hook = lambda group, params: grads.__setitem__(
            group, [p.grad.detach().clone() for p in params])
        frozen = tuple(f"{k}." for k in task.frozen_keys())
        names = {"gen": [n for n, p in task.model.named_parameters()
                         if not n.startswith(frozen)],
                 "disc": [f"disc{dname}.{n}" for dname, d in task.discriminators.items()
                          for n, _ in d.named_parameters()]}
        t_gen = task.training_step(batch, STEP, 0)
        t_disc = task.training_step(batch, STEP, 1)
    j_gen = jtask.training_step(batch, STEP, 0)
    j_disc = jtask.training_step(batch, STEP, 1)
    st = jax.device_get(jtask.state)

    _check_losses(t_gen[1], j_gen[1], "gen")
    _check_losses(t_disc[1], j_disc[1], "disc")
    pretrained = name.endswith(PRETRAINED)
    asr = ({"asr"} if "PPGTask" in name and "Para" not in name else
           set() if pretrained else {"asr_a", "asr_p"})
    assert asr <= set(t_gen[1])
    if name.endswith("ConstraintTask"):
        assert "ppg_constraint" in t_gen[1]
    if name.endswith("SpkConsistentTask"):
        assert {k for k in t_gen[1] if "_spk" in k} and {k for k in t_disc[1] if "_spk" in k}
    want = _torch_names(st0, st["opt_gen"][0]["g"], st["opt_disc"][0]["g"])
    settled = _check_grads(grads["gen"], want, names["gen"], "gen")
    settled.update(_check_grads(grads["disc"], want, names["disc"], "disc"))
    init = vcppg_from_jax(st0["params"], st0["batch_stats"])
    if pretrained:
        # the frozen ASR is out of the optimizer and unchanged, bit for bit
        assert not any(n.startswith("vc_asr.") for n in names["gen"])
        assert all(torch.equal(v, init[k]) for k, v in task.model.state_dict().items()
                   if k.startswith("vc_asr."))
    else:
        # only the CE loss reaches the ASR: its prenet's BatchNorm trains
        # through the eval-mode affine, the decoder head through the tokens
        asr_grads = {n: g for n, g in zip(names["gen"], grads["gen"])
                     if n.startswith("vc_asr.")}
        assert any(float(g.abs().max()) > 0 for n, g in asr_grads.items()
                   if n.startswith("vc_asr.asr_decoder."))
    _check_state(task, _torch_names(st), max(j_gen[1]["lr_0"], j_disc[1]["lr_1"]),
                 settled, "after gen+disc")
    asr_stats = {k: v for k, v in task.model.state_dict().items()
                 if k.startswith("vc_asr.") and "running" in k}
    assert all(torch.equal(v, init[k]) for k, v in asr_stats.items())


def test_spk_discs_share_one_clipped_optimizer(hp, patched, monkeypatch):
    """The speaker-consistency task's two discriminators step under one
    AdamW whose clip by global norm spans both (the JAX package's one
    ``tx_disc`` over its ``disc_params`` dict): with
    ``discriminator_grad_norm`` below the union's gradient norm, the clipped
    union has exactly that norm (a clip per discriminator would leave it
    sqrt(2) times larger)."""
    from neuralsvb_torch.tasks import base_task
    hp = dict(hp, discriminator_grad_norm=1e-4)
    norms = []
    clip = base_task.clip_gradients

    def recording_clip(params, max_norm, clip_value):
        clip(params, max_norm, clip_value)
        norms.append((len(params), float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params])))))
    monkeypatch.setattr(base_task, "clip_gradients", recording_clip)
    with hparams_scope(dict(hp)):
        task = _cls("neuralsvb_torch", "svb_para.ParaPPGSpkConsistentTask")()
        task.build_model()
        task.build_train()
        task.disc_start_frames_wins = [0, 0]
        assert task.discriminators.keys() == {"", "_spk"}
        n_disc = sum(len(list(d.parameters())) for d in task.discriminators.values())
        assert [len(g["params"]) for g in task.opt_disc.param_groups] == [n_disc]
        task.training_step(_batch(), STEP, 0)
        pre = {}
        task.grad_hook = lambda group, params: pre.__setitem__(group, float(
            torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                  for p in params]))))
        task.training_step(_batch(), STEP, 1)
    n, clipped = norms[-1]
    assert n == n_disc and pre["disc"] > 1e-4
    np.testing.assert_allclose(clipped, 1e-4, rtol=1e-5)
