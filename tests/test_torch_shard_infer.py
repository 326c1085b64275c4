"""``shard_infer`` on the PyTorch port: the flagship's ``--infer`` over two
gloo ranks on the CPU (``torch.multiprocessing.spawn``, ``mesh_shape:
data:2``, ``infer_batch_size: 2``) on a 5-item test split, so the last
batch is ragged.

Checked: with noise on, each rank's rows of the global batch's draw make
the two ranks' ``mel_out`` equal one process's within 1e-5, the tolerance
of the JAX package's own sharded-eval test (``tests/test_shard_infer.py``);
the wav and mel trees hold the same names and lengths, every item written
once (rank 0 runs the ragged batch); each rank reports its own vocoder
calls, and they sum to one process's. At zero noise the ranks' a2p
``mel_out`` of the first batch is held against the JAX model's forward on
one device (what its ``_eval_forward`` applies) at the same 1e-5. Without
a launched world the option changes nothing (``shard_infer: true`` is set
in every run)."""

from __future__ import annotations

import glob
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import torch.multiprocessing as mp  # noqa: E402

from tests.test_torch_ddp_worker import run_infer  # noqa: E402
from tests.test_torch_infer_e2e import HP, SIBLING, VOC  # noqa: E402
from tests.test_torch_support import agree, jax_zero_noise, seeded, one_torch_thread  # noqa: E402,F401
from tests.test_torch_svb_vae import TINY, jax_svbvae  # noqa: E402

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402
from neuralsvb_torch.models.hifigan import HifiGanGenerator  # noqa: E402
from neuralsvb_torch.models.svb_vae import SVBVAE  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FRAMES = (72, 64, 56, 80, 48)
KEYS = ("gt_a", "gt_p", "a2a", "p2p", "a2p")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_infer")
    data, voc = root / "data", root / "voc"
    write_synthetic_split(str(data), FRAMES, seed=5)
    voc.mkdir()
    (voc / "config.yaml").write_text(yaml.safe_dump(VOC))
    gen = seeded(lambda: HifiGanGenerator(**VOC), 11)
    torch.save({"state_dict": {"model_gen": gen.state_dict()}}, voc / "model_ckpt_steps_1.ckpt")
    model = seeded(lambda: SVBVAE(100, **TINY), 12)
    (root / "ckpt").mkdir()
    torch.save({"state_dict": {"model": model.state_dict()}, "global_step": 5},
               root / "ckpt" / "model_ckpt_steps_5.ckpt")
    cfg = dict(HP, base_config=[SIBLING], binary_data_dir=str(data), vocoder_ckpt=str(voc),
               infer_batch_size=2, shard_infer=True, zero_noise=False)
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    hp = set_hparams(config=str(root / "cfg.yaml"), hparams_str="device=cpu",
                     print_hparams=False, global_hparams=False)
    hp["infer"] = True
    works = {}
    for name in ("one_noise", "one_zero", "two_noise", "two_zero"):
        works[name] = root / name
        shutil.copytree(root / "ckpt", works[name])
    summaries = {}
    for name, zero in (("one_noise", False), ("one_zero", True)):
        with hparams_scope(dict(hp, work_dir=str(works[name]), mesh_shape="",
                                zero_noise=zero)):
            from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
            summaries[name] = [SVBVAEMleTask.start()]
    mp.spawn(run_infer, args=(2, str(root / "pg"), dict(hp, mesh_shape="data:2"),
                              [dict(work_dir=str(works["two_noise"]), zero_noise=False),
                               dict(work_dir=str(works["two_zero"]), zero_noise=True)]),
             nprocs=2)
    for name in ("two_noise", "two_zero"):
        summaries[name] = [json.load(open(works[name] / f"summary.{r}.json")) for r in (0, 1)]
    return root, works, summaries, model, hp


def _tree(work, kind, ext):
    out = {}
    for key in KEYS:
        sub = f"{key}_wavout" if kind == "wavs" else f"{key}_mel"
        for f in sorted(glob.glob(str(work / "generated_5_" / kind / sub / f"*.{ext}"))):
            out[f"{sub}/{os.path.basename(f)}"] = f
    return out


def test_two_ranks_equal_one_process(runs):
    import wave
    root, works, summaries, _, _ = runs
    for noise in ("noise", "zero"):
        one, two = works[f"one_{noise}"], works[f"two_{noise}"]
        mels1, mels2 = _tree(one, "mels", "npy"), _tree(two, "mels", "npy")
        assert mels1.keys() == mels2.keys() and len(mels1) == len(KEYS) * len(FRAMES)
        for k in mels1:
            agree(np.load(mels2[k]), np.load(mels1[k]), 1e-5, k)
        wavs1, wavs2 = _tree(one, "wavs", "wav"), _tree(two, "wavs", "wav")
        assert wavs1.keys() == wavs2.keys()
        for k in wavs1:
            with wave.open(wavs1[k]) as a, wave.open(wavs2[k]) as b:
                assert a.getnframes() == b.getnframes(), k
        s1, (r0, r1) = summaries[f"one_{noise}"][0], summaries[f"two_{noise}"]
        assert (r0["rank"], r1["rank"], r0["world"], s1["world"]) == (0, 1, 2, 1)
        # batches (2, 2, 1): each rank runs a row of the first two, rank 0
        # the ragged last one whole
        assert (r0["utts"], r1["utts"], s1["utts"]) == (3, 2, 5)
        assert r0["vocoder_calls"] + r1["vocoder_calls"] == s1["vocoder_calls"] == 25


def test_ranks_match_jax_eval_forward(runs):
    """Batch 0's a2p rows at zero noise: the ranks' against the JAX model on
    one device (``_eval_forward``'s apply)."""
    from neuralsvb_tpu.hparams import hparams_scope as jax_scope
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    root, works, _, model, hp = runs
    with hparams_scope(dict(hp, work_dir=str(works["two_zero"]))):
        batch = next(iter(SVBVAEMleTask().test_dataloader()))
    jm, params, stats = jax_svbvae(model, dict_size=100)
    args = (batch["mels"], batch["prof_mels"], batch["pitch"].astype(np.int32),
            batch["prof_pitch"].astype(np.int32), batch["multi_spk_emb"][:, 0],
            batch["a2p_f0_alignment"].astype(np.int32))
    with jax_scope(dict(hp)), jax_zero_noise():
        rj = jm.apply({"params": params, "batch_stats": stats}, *args,
                      concurrent_ways=("a2a", "p2p", "a2p"),
                      rngs={"noise": jax.random.PRNGKey(0)})
    for i in range(batch["nsamples"]):
        Tp = int(batch["prof_mel_lengths"][i])
        f = (works["two_zero"] / "generated_5_" / "mels" / "a2p_mel"
             / f"[{i:06d}][{batch['item_name'][i]}][P].npy")
        agree(np.load(f), np.asarray(rj["a2p"]["mel_out"])[i, :Tp], 1e-5, f"a2p row {i}")


def test_without_a_world_the_option_changes_nothing(runs):
    root, works, summaries, _, hp = runs
    s = summaries["one_noise"][0]
    assert s["world"] == 1 and s["utts"] == 5
