"""Multi-directory training (``binary_data_dirs``) and the conditional
discriminator (``use_cond_disc``) of the port against the JAX package.

- ``BaseConcatDataset`` over ``[dir, dir]``: length, ``sizes``, the shuffled
  order, every item and the collated batches equal the JAX concatenation's
  (JAX test: ``tests/test_data_pipeline.py:349-354``), and
  ``maybe_concat_dataset`` builds it from ``binary_data_dirs``.
- The flagship with ``cache_ppg`` on over a concatenation: the members'
  items carry member-local ids, so the PPG cache would give two members'
  item 0 one row; the port streams instead, as the JAX device cache does
  (``neuralsvb_tpu/data/device_cache.py:120-133``), says so, and its gen
  and map steps equal the steps with ``cache_ppg`` off, bit for bit.
- ``Discriminator(cond_size=16)`` called with a ``cond``: the conditional
  branch equals the JAX module's (``tests/test_models.py:180-190``) at
  ``tests/test_torch_disc.py``'s tolerance (1e-5), in eval and in training.
- In a task, ``use_cond_disc: true`` leaves the discriminator with no
  ``cond_disc`` parameters on either side (no task passes a ``cond``): the
  port's parameter tree and optimizer equal those without the option and
  the tree of the JAX task's discriminator (built and initialized as
  ``SVBVAETaskBase.build_model`` and ``_init_params`` do it), and the gen
  and disc steps are bit for bit the steps without it
  (``tests/test_torch_train_step.py`` holds those against JAX).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests import test_torch_train_e2e as e2e  # noqa: E402
from tests import test_torch_train_step as svb_step  # noqa: E402
from tests.test_torch_support import agree, one_torch_thread  # noqa: E402,F401

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.convert.jax2torch import disc_from_jax  # noqa: E402
from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data_hp():
    """The flagship recipe at the tiny widths of ``tests/test_torch_train_e2e.py``."""
    from neuralsvb_torch.hparams import set_hparams
    hp = set_hparams(config=e2e.SIBLING, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    return dict(hp, **e2e.HP)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    a, b = (tmp_path_factory.mktemp(n) for n in ("dir_a", "dir_b"))
    write_synthetic_split(str(a), (72, 64, 80), prefix="train", seed=1)
    write_synthetic_split(str(b), (56, 88), prefix="train", seed=2)
    return str(a), str(b)


def _with_jax_hparams(hp):
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(hp)
    return saved


@pytest.mark.parametrize("same_dir", [True, False])
def test_concat_dataset_matches_jax(data_dirs, data_hp, same_dir):
    from neuralsvb_tpu.data import datasets as jds
    from neuralsvb_torch.data import datasets as tds
    dirs = [data_dirs[0], data_dirs[0] if same_dir else data_dirs[1]]
    hp = dict(data_hp, binary_data_dir=dirs[0], binary_data_dirs=dirs)
    saved = _with_jax_hparams(hp)
    try:
        with hparams_scope(hp):
            jcat = jds.maybe_concat_dataset(jds.MultiSpkEmbDataset, "train", shuffle=True)
            tcat = tds.maybe_concat_dataset(tds.MultiSpkEmbDataset, "train", shuffle=True)
            assert isinstance(tcat, tds.BaseConcatDataset)
            assert len(tcat) == len(jcat) == 6 - (not same_dir)
            assert tcat.sizes == jcat.sizes
            for _ in range(2):  # the concatenation's own stream moves on
                order = tcat.ordered_indices()
                assert np.array_equal(order, jcat.ordered_indices())
            for i in range(len(tcat)):
                t, j = tcat[i], jcat[i]
                assert t.keys() <= j.keys() | {"text"}
                for k in t:
                    if isinstance(t[k], np.ndarray):
                        assert np.array_equal(t[k], np.asarray(j[k])), (i, k)
            idx = [int(i) for i in order[:4]]
            tb = tcat.collater([tcat[i] for i in idx])
            jb = jcat.collater([jcat[i] for i in idx])
            for k in ("mels", "prof_mels", "pitch", "a2p_f0_alignment", "multi_spk_emb", "id"):
                assert np.array_equal(tb[k], jb[k]), k
        with hparams_scope(dict(hp, binary_data_dirs=[])):
            assert isinstance(tds.maybe_concat_dataset(tds.MultiSpkEmbDataset, "train", True),
                              tds.MultiSpkEmbDataset)
    finally:
        jhparams.clear()
        jhparams.update(saved)


def _flagship_steps(hp, data_dirs, capsys):
    """A port flagship's gen and map steps on the first training batch of
    ``hp``'s data; returns (logs, the model's state, stdout, the batch)."""
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    with hparams_scope(hp):
        task = SVBVAEMleTask()
        task.build_model()
        task.build_train()
        task.disc_start_frames_wins = [0, 0]
        batch = next(iter(task.train_dataloader()))
        logs = {}
        for step, idx in ((1, 0), (101, 2)):
            logs.update({k: float(v) for k, v in task.training_step(batch, step, idx)[1].items()})
        state = {k: v.clone() for k, v in task.model.state_dict().items()}
    return logs, state, capsys.readouterr().out, batch


def test_ppg_cache_streams_over_a_concatenation(data_dirs, data_hp, capsys):
    hp = dict(data_hp, binary_data_dir=data_dirs[0], binary_data_dirs=[data_dirs[0]] * 2,
              zero_noise=True)
    cached, st_on, out, batch = _flagship_steps(dict(hp, cache_ppg=True), data_dirs, capsys)
    assert len(set(batch["id"])) < len(batch["id"])  # member-local ids repeat
    assert "PPG cache: the train items' ids are not global indices" in out
    streamed, st_off, out_off, _ = _flagship_steps(dict(hp, cache_ppg=False), data_dirs, capsys)
    assert "PPG cache" not in out_off
    assert cached == streamed
    assert all(torch.equal(v, st_off[k]) for k, v in st_on.items())


def _jax_cond_disc():
    from neuralsvb_tpu.models import disc as jdisc
    jm = jdisc.Discriminator(time_lengths=(8, 16), freq_length=80, hidden_size=8,
                             norm_type="bn", cond_size=16)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 40, 80)))
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 40, 16)))
    x[1, 30:] = 0.0  # a padded item
    rngs = {"params": jax.random.PRNGKey(2), "disc": jax.random.PRNGKey(3),
            "dropout": jax.random.PRNGKey(4)}
    v = jm.init(rngs, x, cond, train=True)
    rs = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        v["batch_stats"])
    return jm, {"params": v["params"], "batch_stats": stats}, x, cond


@pytest.mark.parametrize("train", [False, True])
def test_cond_disc_matches_jax(train, monkeypatch):
    from neuralsvb_torch.models import common as tcommon
    from neuralsvb_torch.models import disc as tdisc
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    jm, v, x, cond = _jax_cond_disc()
    assert set(v["params"]) == {"discriminator", "cond_disc"}
    tm = tdisc.Discriminator((8, 16), 80, 8, "bn", cond_size=16)
    assert tm.cond_disc is None  # built at the first call with a cond
    tm.build_cond_disc()
    sd = disc_from_jax(jax.device_get(v["params"]), jax.device_get(v["batch_stats"]))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    tm.train(train)
    starts = [3, 11]
    out = tm(torch.tensor(x), starts, cond=torch.tensor(cond))
    if train:
        jout, mut = jm.apply(v, x, cond, start_frames_wins=starts, train=True,
                             rngs={"dropout": jax.random.PRNGKey(6)}, mutable=["batch_stats"])
        got = {k: t.detach().numpy() for k, t in tm.state_dict().items() if "running" in k}
        want = {k: t.numpy() for k, t in disc_from_jax(
            jax.device_get(v["params"]), jax.device_get(mut["batch_stats"])).items()
            if "running" in k}
        for k in want:
            agree(torch.tensor(got[k]), want[k], 1e-5, k)
    else:
        jout = jm.apply(v, x, cond, start_frames_wins=starts)
    agree(out["y"], np.asarray(jout["y"]), 1e-5, "y")
    agree(out["y_c"], np.asarray(jout["y_c"]), 1e-5, "y_c")
    out2 = tm(torch.tensor(x), starts, cond=torch.tensor(cond) * 10)
    assert not torch.allclose(out["y_c"], out2["y_c"]) and torch.equal(out["y"], out2["y"])
    assert tm(torch.tensor(x), starts)["y_c"] is None


def _jax_task_disc(hp):
    """The JAX task's discriminator variables: ``Discriminator`` as
    ``SVBVAETaskBase.build_model`` builds it (``svb_vae_task.py:296``) and
    initialized as ``_init_params`` does, without a ``cond``."""
    from neuralsvb_tpu.models.disc import Discriminator as JDisc
    d = JDisc(time_lengths=tuple([32, 64, 128][: hp["disc_win_num"]]),
              freq_length=hp["audio_num_mel_bins"], hidden_size=hp["mel_disc_hidden_size"],
              norm_type=hp["disc_norm"], reduction=hp["disc_reduction"],
              cond_size=hp["hidden_size"] if hp["use_cond_disc"] else 0)
    dummy = np.zeros((2, 2 * max(d.time_lengths), hp["audio_num_mel_bins"]), np.float32)
    v = d.init({"params": jax.random.PRNGKey(2), "disc": jax.random.PRNGKey(3),
                "dropout": jax.random.PRNGKey(5)}, dummy, train=True)
    return {"disc_params": v["params"], "disc_batch_stats": v.get("batch_stats", {})}


def test_task_cond_disc_has_no_cond_parameters():
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    hp = dict(svb_step.HP, use_cond_disc=True, zero_noise=True)
    st = jax.device_get(_jax_task_disc(hp))
    assert set(st["disc_params"]) == {"discriminator"}
    runs = {}
    for cond in (True, False):
        with hparams_scope(dict(hp, use_cond_disc=cond)):
            task = SVBVAEMleTask()
            task.build_model()
            task.build_train()
            assert task.mel_disc.cond_size == (hp["hidden_size"] if cond else 0)
            task.mel_disc.load_state_dict(disc_from_jax(st["disc_params"],
                                                        st["disc_batch_stats"]))
            task.disc_start_frames_wins = [0, 0]
            logs = {}
            for idx in (0, 1):
                logs.update(task.training_step(svb_step._batch(), 1, idx)[1])
            assert task.mel_disc.cond_disc is None
            runs[cond] = (logs, set(task.mel_disc.state_dict()),
                          [p.shape for p in task.disc_params],
                          {k: v.clone() for k, v in task.mel_disc.state_dict().items()})
    assert runs[True][1] == runs[False][1] == set(disc_from_jax(st["disc_params"],
                                                                st["disc_batch_stats"]))
    assert runs[True][2] == runs[False][2]
    assert {k: float(v) for k, v in runs[True][0].items()} == \
        {k: float(v) for k, v in runs[False][0].items()}
    assert all(torch.equal(v, runs[False][3][k]) for k, v in runs[True][3].items())

