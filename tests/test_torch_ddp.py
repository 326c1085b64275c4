"""Data-parallel training of the port (``parallel/ddp.py``) against one
process and against the JAX package's ``mesh_shape: data:2``.

One spawn per file: two ranks join a gloo world through a file
(``tests/test_torch_ddp_worker.py``) and run the jobs below, each one
training step of a port task at ``mesh_shape: data:2`` on the same global
batch:

- the flagship ``SVBVAEMleTask`` (tiny widths of ``tests/test_cycle.py``,
  B = 4) through its gen + disc step (step 1) and its map step (step 101),
  in float64 with every random draw live (posterior noise, dropout, window
  starts);
- the same gen + disc step in float32 with no random draw (zero noise,
  all-keep dropout, windows at 0: what the JAX side can be made to draw);
- ``VCPPGTask`` (the tiny ``vc_ppg.yaml`` widths of
  ``tests/test_torch_vcppg_step.py``, B = 4, phone tokens) through its gen +
  disc step, and ``PWGTask`` (the widths of ``tests/test_torch_pwg_step.py``,
  B = 2) through its gen + disc step, both in float64 with every random
  draw live, from the port's seeded weights; ``ParaPPGSpkConsistentTask``
  likewise (B = 4 paired rows, windows at 0), whose two discriminators'
  gradients average and whose BatchNorm statistics run over the world;
- ``HifiGanTask`` (the widths of ``tests/test_torch_vocoder_step.py``,
  B = 2) through its generator step, in float64 with the NSF draws live
  (with ResBlock2 towers: the ResBlock1 cluster's op takes float32 and
  bf16 only), and in float32 with zero noise (the generator, its gradients and its
  optimizer are compared; the discriminators are left out of the results,
  at 1024 channels they would take gigabytes in float64).

The float64 runs are held against the same steps in this process at
``data:1`` on the global batch: losses, gradients, parameters, BatchNorm
statistics and Adam's moments within 1e-6 relative (each tensor against its
own largest magnitude), and the two ranks bit for bit against each other.
Float64 keeps the bound meaningful: the two runs sum in different orders,
and in float32 Adam's first step (about lr x sign(g)) turns the rounding of
a gradient that is zero in exact arithmetic into a move of lr. The float32
runs are held against the JAX task at ``data:2`` on the 8-device virtual
CPU mesh (``tests/conftest.py``) at the tolerances of
``tests/test_torch_train_step.py`` and ``tests/test_torch_vocoder_step.py``.

Also: the user's entry point, ``torch.distributed.run --standalone
--nproc_per_node 2 -m neuralsvb_torch.tasks.run`` on the ``pwg_torch.yaml``
recipe over gloo on the CPU (rank 0 alone saves, both ranks end with one
``state_digest``, and both resume from rank 0's checkpoint); the batch
budget against the JAX ``build_dataloader`` at N = 2; and the meshes the
port refuses (a ``model`` axis; a ``data`` size other than
the launched world, for the SVB tasks and both vocoder tasks).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tests import test_torch_pwg_step as pwg_step  # noqa: E402
from tests import test_torch_train_step as svb_step  # noqa: E402
from tests import test_torch_vcppg_step as vcppg_step  # noqa: E402
from tests import test_torch_vocoder_step as voc_step  # noqa: E402
from tests.test_cycle import TINY  # noqa: E402
from tests.test_torch_ddp_worker import run_jobs, step_job  # noqa: E402
from tests.test_torch_support import jax_zero_noise, one_torch_thread  # noqa: E402,F401

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import (disc_from_jax, hifigan_from_jax,  # noqa: E402
                                               mpd_from_jax, msd_from_jax,
                                               svbvae_mle_from_jax)
from neuralsvb_torch.hparams import hparams_scope, load_config_recursive  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLD = 2
SVB_HP = dict(TINY, wire_dtype="float32", device="cpu", max_frames=5000)
B, T = 4, 64
LENS_A, LENS_P = (64, 56, 40, 48), (60, 64, 48, 36)
SVB_STEPS = [(1, 0), (1, 1)]
REL = 1e-6  # the float64 runs: data:2 against data:1


def svb_batch():
    rng = np.random.RandomState(1)
    ma = (np.arange(T)[None] < np.asarray(LENS_A)[:, None])
    mp_ = (np.arange(T)[None] < np.asarray(LENS_P)[:, None])
    align = np.stack([np.sort(rng.randint(0, la, T)) for la in LENS_A]) * mp_
    return dict(
        id=np.arange(B), nsamples=B,
        mels=((rng.randn(B, T, 80) - 2) * ma[..., None]).astype(np.float32),
        prof_mels=((rng.randn(B, T, 80) - 2) * mp_[..., None]).astype(np.float32),
        pitch=(rng.randint(1, 255, (B, T)) * ma).astype(np.int64),
        prof_pitch=(rng.randint(1, 255, (B, T)) * mp_).astype(np.int64),
        a2p_f0_alignment=align.astype(np.int64),
        multi_spk_emb=rng.randn(B, 5, 256).astype(np.float32))


def vcppg_batch():
    """``svb_batch`` with the energies and the phone tokens ``VCPPGTask``
    reads (token lengths 12, 9, 7, 10 of 12)."""
    b = svb_batch()
    rng = np.random.RandomState(2)
    mt = np.arange(12)[None] < np.asarray((12, 9, 7, 10))[:, None]
    for side, mels in (("", "mels"), ("prof_", "prof_mels")):
        b[f"{side}energy"] = (np.sqrt((np.exp(b[mels]) ** 2).sum(-1))
                              * (b[f"{side}pitch"] > 0)).astype(np.float32)
    b["txt_tokens"] = (rng.randint(4, vcppg_step.N_PHONES + 4, (B, 12)) * mt).astype(np.int64)
    return b


def _patched_jax():
    """All-keep dropout and zero noise on the JAX side (restored after)."""
    bern = jax.random.bernoulli
    jax.random.bernoulli = lambda key, p=0.5, shape=None: jnp.ones(shape, bool)
    ctx = jax_zero_noise()
    ctx.__enter__()

    def restore():
        ctx.__exit__(None, None, None)
        jax.random.bernoulli = bern
    return restore


@pytest.fixture(scope="module")
def jax_svb():
    """The JAX flagship at data:2: its initial state, and its state and
    losses after the gen + disc step at step 1."""
    from neuralsvb_tpu.tasks.svb_vae_task import SVBVAEMleTask
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(dict(SVB_HP, mesh_shape="data:2"))
    task = SVBVAEMleTask()
    task.build_model()
    task.tx_gen = optax.chain(svb_step._capture(), task.tx_gen)
    task.tx_disc = optax.chain(svb_step._capture(), task.tx_disc)
    st0 = jax.device_get(task.state)
    st0["opt_gen"] = task.tx_gen.init({k: v for k, v in st0["params"].items()
                                       if task._gen_key_filter(k)})
    st0["opt_disc"] = task.tx_disc.init(st0["disc_params"])
    st0 = jax.device_get(st0)
    task.set_state(jax.tree_util.tree_map(np.array, st0))
    task._np_rng = np.random.RandomState(SVB_HP["seed"])
    restore = _patched_jax()
    try:
        logs = {}
        for step, idx in SVB_STEPS:
            logs.update(task.training_step(svb_batch(), step, idx)[1])
    finally:
        restore()
    st = jax.device_get(task.state)
    jhparams.clear()
    jhparams.update(saved)
    return st0, st, logs


@pytest.fixture(scope="module")
def voc_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_vocoder_data")
    voc_step.write_vocoder_split(str(root), voc_step.FRAMES, "train", 1)
    return str(root)


@pytest.fixture(scope="module")
def jax_voc(voc_data):
    """The JAX HifiGanTask at data:2, its batch and its steps' results."""
    from neuralsvb_tpu.tasks.vocoder_task import HifiGanTask as JTask
    from neuralsvb_torch.tasks.vocoder_task import VocoderDataset
    hp = dict(voc_step.HP, binary_data_dir=voc_data, mesh_shape="data:2")
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(hp)
    task = JTask()
    task.build_model()
    task.tx_gen = optax.chain(voc_step._capture(), task.tx_gen)
    task.tx_disc = optax.chain(voc_step._capture(), task.tx_disc)
    st0 = jax.device_get(task.state)
    st0["opt_gen"] = task.tx_gen.init(st0["params"])
    st0["opt_disc"] = task.tx_disc.init({"mpd": st0["mpd"], "msd": st0["msd"]})
    task.set_state(st0)
    with hparams_scope(dict(hp, mesh_shape="")):
        ds = VocoderDataset("train")
        batch = ds.collater([ds[0], ds[4]])
    with jax_zero_noise():
        logs = task.training_step(batch, voc_step.STEP, 0)[1]
    st = jax.device_get(task.state)
    jhparams.clear()
    jhparams.update(saved)
    return st0, st, logs, batch, hp


def _seeded(kind, hp):
    """The port's seeded task of ``kind`` for ``hp``: its modules' state_dicts."""
    from tests.test_torch_ddp_worker import build_task, modules
    with hparams_scope(dict(hp, mesh_shape="")):
        return {n: m.state_dict() for n, m in modules(build_task(kind), kind).items()}


@pytest.fixture(scope="module")
def vcppg_hp(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_ppg_bin")
    (d / "phone_set.json").write_text(
        json.dumps([f"p{i}" for i in range(vcppg_step.N_PHONES)]))
    cfg = load_config_recursive(os.path.join(vcppg_step.REPO, "egs/egs_bases/vc/vc_ppg.yaml"))
    return dict(cfg, **vcppg_step.TINY, binary_data_dir=str(d))


@pytest.fixture(scope="module")
def pwg_job(tmp_path_factory):
    """The PWG job's hparams and batch: two random crops of 16 frames."""
    from neuralsvb_torch.tasks.vocoder_task import VocoderDataset
    root = str(tmp_path_factory.mktemp("ddp_pwg_data"))
    pwg_step.write_vocoder_split(root, (10, 40, 16, 23, 64, 12), "train", 1)
    hp = dict(pwg_step.HP, binary_data_dir=root)
    with hparams_scope(hp):
        ds = VocoderDataset("train")
        batch = ds.collater([ds[1], ds[4]])
    return hp, batch


def para_batch():
    """Four rows of ``tests/test_torch_vcppg_step.py``'s paired batch with
    phone tokens (it has three)."""
    a, b = vcppg_step._batch(1), vcppg_step._batch(2)
    out = {k: np.concatenate([v, b[k][:1]]) for k, v in a.items()
           if isinstance(v, np.ndarray)}
    return dict(out, id=np.arange(4), nsamples=4)


@pytest.fixture(scope="module")
def jobs(jax_svb, jax_voc, vcppg_hp, pwg_job):
    """The four jobs (see the module docstring), keyed by name, and the
    initial states (the JAX tasks' weights, converted) under 'states'."""
    st0, *_ = jax_svb
    vst0, _, _, vbatch, vhp = jax_voc
    svb = dict(kind="svb", hp=dict(SVB_HP, mesh_shape="data:2"), batch=svb_batch(),
               state="svb")
    voc = dict(kind="hifigan", hp=dict(vhp, mesh_shape="data:2"), batch=vbatch,
               steps=[(voc_step.STEP, 0)], keep=("model",), keep_opts=1, state="voc")
    return {
        "states": {
            "svb": {"model": svbvae_mle_from_jax(st0["params"], st0["batch_stats"]),
                    "mel_disc": disc_from_jax(st0["disc_params"], st0["disc_batch_stats"])},
            "voc": {"model": hifigan_from_jax(vst0["params"]), "mpd": mpd_from_jax(vst0["mpd"]),
                    "msd": msd_from_jax(vst0["msd"])},
            "voc2": {"model": _seeded("hifigan", dict(vhp, resblock="2"))["model"],
                     "mpd": mpd_from_jax(vst0["mpd"]), "msd": msd_from_jax(vst0["msd"])},
            "vcppg": _seeded("vcppg", vcppg_hp), "pwg": _seeded("pwg", pwg_job[0]),
            "spk": _seeded("spk", vcppg_hp)},
        "svb64": dict(svb, dtype="float64", steps=SVB_STEPS + [(101, 2)]),
        "svb32": dict(svb, dtype="float32", steps=SVB_STEPS,
                      hp=dict(svb["hp"], zero_noise=True), all_keep=True, windows=[0, 0]),
        # ResBlock2 towers: the ResBlock1 cluster's op takes f32 and bf16 only
        "voc64": dict(voc, dtype="float64", hp=dict(voc["hp"], zero_noise=False, resblock="2"),
                      state="voc2"),
        "voc32": dict(voc, dtype="float32"),
        "vcppg64": dict(kind="vcppg", hp=dict(vcppg_hp, mesh_shape="data:2"),
                        batch=vcppg_batch(), steps=[(1, 0), (1, 1)], dtype="float64",
                        state="vcppg"),
        # the speaker-consistency task: two discriminators under one optimizer
        "spk64": dict(kind="spk", hp=dict(vcppg_hp, mesh_shape="data:2"),
                      batch=para_batch(), steps=[(1, 0), (1, 1)], dtype="float64",
                      state="spk", windows=[0, 0]),
        "pwg64": dict(kind="pwg", hp=dict(pwg_job[0], mesh_shape="data:2"), batch=pwg_job[1],
                      steps=[(pwg_step.STEP, 0), (pwg_step.STEP, 1)], dtype="float64",
                      state="pwg"),
    }


@pytest.fixture(scope="module")
def ranks(jobs, tmp_path_factory):
    """Every job's result on each of the two ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("ddp")
    torch.save(jobs, tmp / "jobs.pt")
    mp.spawn(run_jobs, args=(WORLD, str(tmp / "pg"), str(tmp / "jobs.pt"), str(tmp / "out")),
             nprocs=WORLD)
    return [torch.load(tmp / f"out.{r}", weights_only=False) for r in range(WORLD)]


def _tensors(res):
    """A result's tensors by name: state, gradients, Adam's moments."""
    out = {f"{m}.{k}": v for m, sd in res["state"].items() for k, v in sd.items()
           if v.is_floating_point()}
    for group, gs in res["grads"].items():
        out.update({f"grad.{group}.{i}": g for i, g in enumerate(gs)})
    for j, opt in enumerate(res["opt"]):
        for i, st in opt["state"].items():
            out.update({f"opt{j}.{i}.{k}": v for k, v in st.items()
                        if torch.is_tensor(v) and v.is_floating_point()})
    return out


@pytest.mark.parametrize("name", ["svb64", "voc64", "vcppg64", "pwg64", "spk64"])
def test_two_ranks_equal_one_process(jobs, ranks, name):
    job = jobs[name]
    one = step_job(dict(job, hp=dict(job["hp"], mesh_shape="")), jobs["states"])
    r0, r1 = (r[name] for r in ranks)
    assert one["logs"].keys() == r0["logs"].keys() == r1["logs"].keys()
    for k, v in one["logs"].items():
        assert r0["logs"][k] == r1["logs"][k], k
        assert abs(r0["logs"][k] - v) <= REL * max(abs(v), 1e-12), (k, r0["logs"][k], v)
    want, got, other = _tensors(one), _tensors(r0), _tensors(r1)
    assert want.keys() == got.keys() == other.keys()
    assert len(want) > 100
    # a tensor's scale: its largest magnitude, but at least 1e-3 of its
    # group's (a parameter or gradient that is zero in exact arithmetic is
    # rounding on both sides)
    groups = {}
    for k, v in want.items():
        g = k.rsplit(".", 2)[0] if k.startswith(("grad.", "opt")) else k.split(".")[0]
        groups[g] = max(groups.get(g, 0.0), float(v.abs().max()))
    for k, v in want.items():
        g = k.rsplit(".", 2)[0] if k.startswith(("grad.", "opt")) else k.split(".")[0]
        assert torch.equal(got[k], other[k]), f"the ranks differ at {k}"
        d = float((got[k] - v).abs().max())
        scale = max(float(v.abs().max()), 1e-3 * groups[g], 1e-30)
        assert d <= REL * scale, f"{k}: max|d| {d:.3e} vs scale {scale:.3e}"


def _jax_mu(opt_state):
    """Adam's first moment out of an optax chain's state."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise KeyError("mu")


def test_two_ranks_match_jax_flagship(jax_svb, ranks):
    """The port's data:2 gen + disc step against the JAX data:2 step (the
    criteria of ``tests/test_torch_train_step.py``), and Adam's first
    moment within the gradient tolerance times (1 - b1)."""
    st0, st, jlogs = jax_svb
    res = ranks[0]["svb32"]
    svb_step._check_losses(res["logs"], jlogs, "data:2")
    with hparams_scope(dict(SVB_HP, mesh_shape="")):
        from tests.test_torch_ddp_worker import build_task
        task = build_task("svb")
    names = svb_step._port_names(task)
    want = svb_step._to_torch_names(st0, params=st["opt_gen"][0]["g"],
                                    disc_params=st["opt_disc"][0]["g"])
    settled = svb_step._check_grads(res["grads"]["gen"], want, names["gen"], "gen")
    dwant = {k[5:]: v for k, v in want.items() if k.startswith("disc.")}
    settled.update({f"disc.{k}": v for k, v in svb_step._check_grads(
        res["grads"]["disc"], dwant, names["disc"], "disc").items()})
    task.model.load_state_dict(res["state"]["model"])
    task.mel_disc.load_state_dict(res["state"]["mel_disc"])
    svb_step._check_state(task, st, max(jlogs["lr_0"], jlogs["lr_1"]), settled, "data:2")
    mu = svb_step._to_torch_names(st0, params=_jax_mu(st["opt_gen"][1]),
                                  disc_params=_jax_mu(st["opt_disc"][1]))
    b1 = SVB_HP["optimizer_adam_beta1"]
    for j, group in ((0, "gen"), (1, "disc")):
        scales = svb_step._scales(want if group == "gen" else dwant, names[group])
        for i, n in enumerate(names[group]):
            key = n if group == "gen" else f"disc.{n}"
            d = float(np.abs(res["opt"][j]["state"][i]["exp_avg"].numpy() - mu[key]).max())
            assert d <= 1e-3 * (1 - b1) * scales[n], f"mu {n}: {d:.3e}"


def test_two_ranks_match_jax_vocoder(jax_voc, ranks):
    """The port's data:2 HifiGanTask generator step against the JAX data:2
    step (the criteria of ``tests/test_torch_vocoder_step.py``)."""
    st0, st, jlogs, _, _ = jax_voc
    res = ranks[0]["voc32"]
    got = {k: v for k, v in res["logs"].items() if not k.startswith("lr_")}
    assert got.keys() == {k for k in jlogs if not k.startswith("lr_")}
    for k, v in got.items():
        np.testing.assert_allclose(v, float(jlogs[k]), rtol=1e-4, err_msg=k)
    from tests.test_torch_ddp_worker import build_task
    with hparams_scope(dict(jax_voc[4], mesh_shape="")):
        task = build_task("hifigan")
    gen_names = [f"gen.{n}" for n, _ in task.model.named_parameters()]
    want = voc_step._torch_names(st["opt_gen"][0]["g"], st["opt_disc"][0]["g"]["mpd"],
                                 st["opt_disc"][0]["g"]["msd"])
    settled = {}
    for group, names in (("gen", gen_names),):
        scales = voc_step._scales(want, names)
        assert len(res["grads"][group]) == len(names)
        for n, g in zip(names, res["grads"][group]):
            d = float(np.abs(g.numpy() - want[n]).max())
            assert d <= 1e-3 * scales[n], f"{n}: max|d| {d:.3e} vs {scales[n]:.3e}"
            settled[n] = np.abs(want[n]) > 2e-3 * scales[n]
    lr = float(res["logs"]["lr_0"])
    after = voc_step._torch_names(st["params"], st["mpd"], st["msd"])
    port = {f"{'gen' if m == 'model' else m}.{k}": v
            for m, sd in res["state"].items() for k, v in sd.items()}
    for k, v in port.items():
        d = np.abs(v.numpy() - after[k])
        tol = np.where(settled[k], voc_step.PARAM_TOL * lr + 1e-6, 2 * lr + 1e-6)
        assert (d <= tol).all(), f"{k}: max|d| {float(d.max()):.3e}"


def _summaries(stdout):
    """The ranks' ``| train summary:`` lines, by rank."""
    return {s["rank"]: s for s in (json.loads(m.group(1)) for m in re.finditer(
        r"^\| train summary: (\{.*\})$", stdout, re.M))}


def test_torchrun_cli_trains_and_resumes(tmp_path):
    """The CLI under ``torch.distributed.run --standalone`` (a rendezvous on
    a free local port): two gloo ranks on the CPU train the PWG recipe at
    ``mesh_shape: data:2`` to step 8, then resume to 10. Rank 0 alone saves
    (one ``Saved ckpt`` line per save), both ranks end each run with one
    ``state_digest``, and both restore step 8 from rank 0's checkpoint."""
    import yaml
    data = tmp_path / "data"
    pwg_step.write_vocoder_split(str(data), (20, 6, 12, 16), "train", 3)
    pwg_step.write_vocoder_split(str(data), (9, 18), "valid", 4)
    hp = {k: v for k, v in pwg_step.CLI_HP.items() if k not in ("device", "mesh_shape")}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(
        dict(hp, base_config=[pwg_step.RECIPE], binary_data_dir=str(data))))

    def cli(extra=""):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(WORLD), "-m", "neuralsvb_torch.tasks.run",
             "--config", str(tmp_path / "cfg.yaml"), "--hparams",
             f"device=cpu,mesh_shape=data:2,work_dir={tmp_path / 'work'}{extra}"],
            cwd=pwg_step.REPO, env=dict(os.environ, PYTHONPATH=pwg_step.REPO),
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        return out.stdout, _summaries(out.stdout)

    first, runs = cli()
    resumed, runs2 = cli(",max_updates=10")
    for out, by_rank, ends in ((first, runs, (0, 8)), (resumed, runs2, (8, 10))):
        assert sorted(by_rank) == [0, 1]
        assert all(r["world"] == WORLD and (r["start_step"], r["end_step"]) == ends
                   for r in by_rank.values()), by_rank
        assert by_rank[0]["state_digest"] == by_rank[1]["state_digest"]
        assert out.count("| data parallel: rank ") == WORLD and "(gloo)" in out
    # rank 0 alone: validations at 4 and 8, and the end of the run
    assert first.count("| Saved ckpt:") == 3
    assert resumed.count("| Restored ckpt:") == WORLD
    assert resumed.count("| Saved ckpt:") == 1
    assert sorted(p.name for p in (tmp_path / "work").glob("model_ckpt_steps_*.ckpt")) == [
        "model_ckpt_steps_10.ckpt", "model_ckpt_steps_8.ckpt"]
    steps = pwg_step._steps(first)
    assert sorted(steps) == list(range(1, 9))
    assert all(np.isfinite(v) for logs in steps.values() for v in logs.values())


class _Sized:
    """A dataset of given sizes for the batching code."""

    def __init__(self, sizes):
        self.sizes = list(sizes)

    def __len__(self):
        return len(self.sizes)

    def num_tokens(self, i):
        return self.sizes[i]

    def ordered_indices(self):
        return np.argsort(self.sizes, kind="mergesort")


@pytest.mark.parametrize("max_tokens, max_sentences, by_size", [
    (400, 5, True), (None, 3, False), (1000, None, True)])
def test_batch_budget_matches_jax(max_tokens, max_sentences, by_size):
    """N = 2: budgets doubled, sizes a multiple of 2, odd batches trimmed
    and empty ones dropped, as the JAX ``build_dataloader`` builds them."""
    from neuralsvb_tpu.tasks.base_task import BaseTask as JBase
    from neuralsvb_torch.tasks.base_task import BaseTask as TBase
    sizes = np.random.RandomState(3).randint(20, 120, 23)
    hp = dict(seed=1234, ds_workers=0, mesh_shape="")
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(hp)
    try:
        want = JBase().build_dataloader(_Sized(sizes), False, max_tokens, max_sentences,
                                        use_batch_by_size=by_size, n_devices=2).batches
    finally:
        jhparams.clear()
        jhparams.update(saved)
    with hparams_scope(hp):
        got = TBase().build_dataloader(_Sized(sizes), False, max_tokens, max_sentences,
                                       use_batch_by_size=by_size, n_devices=2).batches
    assert [list(map(int, b)) for b in got] == [list(map(int, b)) for b in want]
    assert all(len(b) % 2 == 0 and b for b in got)


@pytest.mark.parametrize("cls, mesh, error", [
    ("svb_vae_task.SVBVAEMleTask", "data:1,model:2", NotImplementedError),
    ("svb_vae_task.SVBVAEMleTask", "data:2", ValueError),
    ("svb_vae_task.SVBVAETechMleTask", "data:2", ValueError),
    ("vocoder_task.HifiGanTask", "data:2", ValueError),
    ("vocoder_task.PWGTask", "data:2", ValueError),
    ("vocoder_task.HifiGanTask", "model:2", NotImplementedError)])
def test_refuses_meshes_it_cannot_honour(cls, mesh, error):
    """Without a launched world the port has one process: a data:2 mesh
    raises instead of training on one device with the one-device batch, and
    a model axis (GSPMD tensor parallelism) is not ported."""
    import importlib
    mod, name = cls.split(".")
    task_cls = getattr(importlib.import_module(f"neuralsvb_torch.tasks.{mod}"), name)
    with hparams_scope(dict(SVB_HP, mesh_shape=mesh)), pytest.raises(error, match="mesh_shape"):
        task_cls()
