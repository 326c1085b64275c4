"""The port's binarize path end to end on the CPU, against the JAX
binarizer.

Three songs of the ``_sing`` vibrato pattern (tests/test_data_pipeline.py)
go through both port passes, ``python -m neuralsvb_torch.data.binarize``
with ``SaveSpkEmb`` then ``PopBuTFyENSpkEMBinarizer``, and through both JAX
passes, with the same GE2E checkpoint. Per item: ``mel`` within 1e-5,
``f0`` within 1 Hz and ``pitch`` and ``a2p_f0_alignment`` equal on >= 99%
of frames (they are argmax decisions over float32 costs), the
``multi_spk_emb`` row of the item itself within 1e-5 and the other rows (a
random same-song pick on each side) equal as a set. A run with two worker
processes must write the same items, and the port's ``MultiSpkEmbDataset``
must collate the port's split.
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
yaml = pytest.importorskip("yaml")

from tests.test_torch_ge2e import jax_ge2e_params  # noqa: E402

from neuralsvb_torch.data.indexed_dataset import IndexedDataset  # noqa: E402
from neuralsvb_torch.models.ge2e import SpeakerEncoder  # noqa: E402
from neuralsvb_torch.ops.audio import save_wav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 22050
SONGS = [("Female1", "SongA", 220.0), ("Female1", "SongB", 250.0),
         ("Male6", "SongC", 150.0)]
ITEM_KEYS = ("mel", "prof_mel", "f0", "prof_f0", "pitch", "prof_pitch",
             "a2p_f0_alignment", "multi_spk_emb")


def _sing(freq, dur, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(SR * dur)) / SR
    vib = freq * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    wav = 0.3 * np.sin(2 * np.pi * np.cumsum(vib) / SR)
    return (wav + 0.01 * rng.randn(len(t))).astype(np.float32)


def _hp(root, out):
    return {
        "processed_data_dir": str(root / "processed"),
        "binary_data_dir": str(root / out / "binary"),
        "spk_emb_data_dir": str(root / out / "spk_emb"),
        "datasets": ["Female1#", "Male6#"], "test_prefixes": ["Male6#singing#"],
        "binarization_args": {"with_f0": True, "with_spk_embed": False,
                              "with_wav": False, "shuffle": False},
        "audio_sample_rate": SR, "fft_size": 512, "hop_size": 128, "win_size": 512,
        "audio_num_mel_bins": 80, "fmin": 50, "fmax": 11025, "test_num": 0,
        "num_spk": 10, "ds_workers": 1, "spk_emb_num": 4, "max_mel_tech_gap": 800,
        "vocoder": "pwg", "vocoder_ckpt": "", "ge2e_ckpt": str(root / "ge2e.pt"),
    }


def _port_cli(root, out, cls, extra=""):
    cfg = root / f"{out}_{cls}.yaml"
    cfg.write_text(yaml.safe_dump(dict(
        _hp(root, out), binarizer_cls=f"neuralsvb_torch.data.binarizer.{cls}")))
    res = subprocess.run(
        [sys.executable, "-m", "neuralsvb_torch.data.binarize", "--config", str(cfg),
         "--hparams", "device=cpu" + extra],
        # one intra-op thread: the items are small and the suite runs in parallel
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    m = re.search(r"^\| binarize summary: (\{.*\})$", res.stdout, re.M)
    assert m, res.stdout[-3000:]
    return json.loads(m.group(1))


@pytest.fixture(scope="module")
def binarized(tmp_path_factory):
    root = tmp_path_factory.mktemp("binarize")
    data_dir = root / "processed" / "data" / "part1"
    data_dir.mkdir(parents=True)
    for spk, song, freq in SONGS:
        for idx in range(2):
            dur = 1.2 + 0.12 * idx
            save_wav(_sing(freq * 1.02, dur, seed=idx),
                     str(data_dir / f"{spk}#singing#{song}_Amateur_{idx}.wav"), SR)
            save_wav(_sing(freq, dur * 0.95, seed=idx + 10),
                     str(data_dir / f"{spk}#singing#{song}_Professional_{idx}.wav"), SR)
    enc = SpeakerEncoder(None, torch.device("cpu"), seed=7)
    torch.save(enc.model.state_dict(), root / "ge2e.pt")

    summaries = [_port_cli(root, "port", "SaveSpkEmb"),
                 _port_cli(root, "port", "PopBuTFyENSpkEMBinarizer")]

    import neuralsvb_tpu.convert.torch2jax as t2j
    from neuralsvb_tpu.data.binarizer import PopBuTFyENSpkEMBinarizer, SaveSpkEmb
    from neuralsvb_tpu.hparams import hparams_scope
    convert_ge2e = t2j.convert_ge2e
    t2j.convert_ge2e = lambda path: jax_ge2e_params(path)
    try:
        with hparams_scope(_hp(root, "jax")):
            SaveSpkEmb().process()
            PopBuTFyENSpkEMBinarizer().process()
    finally:
        t2j.convert_ge2e = convert_ge2e
    return root, summaries


def _items(root, out, prefix):
    ds = IndexedDataset(str(root / out / "binary" / prefix))
    return [ds[i] for i in range(len(ds))]


def test_summaries(binarized):
    _, (emb, para) = binarized
    # 6 utterances per singer; the test split is read twice (valid and test)
    assert emb["items"] == {"valid": 4, "test": 4, "train": 8}
    assert para["items"] == {"valid": 2, "test": 2, "train": 4}
    assert set(emb["stage_seconds"]) == {"stft_mel", "ge2e"}
    assert set(para["stage_seconds"]) == {"stft_mel", "pitch", "dtw_align"}
    # CPU tensors take the plain chi-square version: no kernel launches
    assert emb["chi2_dist_launches"] == para["chi2_dist_launches"] == 0
    assert para["device"] == "cpu" and para["max_memory_allocated"] is None


def test_spk_embeddings_match_jax(binarized):
    root, _ = binarized
    names = sorted(os.listdir(root / "jax" / "spk_emb"))
    assert names == sorted(os.listdir(root / "port" / "spk_emb")) and len(names) == 12
    for n in names:
        np.testing.assert_allclose(np.load(root / "port" / "spk_emb" / n),
                                   np.load(root / "jax" / "spk_emb" / n), atol=1e-5)


@pytest.mark.parametrize("prefix", ["train", "test"])
def test_items_match_jax(binarized, prefix):
    root, _ = binarized
    port, ref = _items(root, "port", prefix), _items(root, "jax", prefix)
    assert [i["item_name"] for i in port] == [i["item_name"] for i in ref]
    assert len(port) == (4 if prefix == "train" else 2)
    for p, j in zip(port, ref):
        for key in ITEM_KEYS:
            assert key in p, key
        for side in ("", "prof_"):
            np.testing.assert_allclose(p[f"{side}mel"], j[f"{side}mel"], atol=1e-5)
            assert p[f"{side}f0"].shape == j[f"{side}f0"].shape == (len(p[f"{side}mel"]),)
            assert np.mean(np.abs(p[f"{side}f0"] - j[f"{side}f0"]) <= 1.0) >= 0.99
            assert np.mean(p[f"{side}pitch"] == j[f"{side}pitch"]) >= 0.99
        al = p["a2p_f0_alignment"]
        assert al.shape == (len(p["prof_f0"]),) and al.max() < len(p["f0"])
        assert (np.diff(al[1:]) >= 0).all()
        assert np.mean(al == j["a2p_f0_alignment"]) >= 0.99
        assert p["multi_spk_emb"].shape == (5, 256)
        np.testing.assert_allclose(p["multi_spk_emb"][0], j["multi_spk_emb"][0], atol=1e-5)
        # every row has a twin on the other side: the same set of rows
        d = np.abs(p["multi_spk_emb"][1:, None] - j["multi_spk_emb"][None, 1:]).max(-1)
        assert (d.min(1) <= 1e-5).all() and (d.min(0) <= 1e-5).all()
    for name in (f"{prefix}_lengths.npy", f"{prefix}_f0s_mean_std.npy"):
        np.testing.assert_allclose(np.load(root / "port" / "binary" / name),
                                   np.load(root / "jax" / "binary" / name), rtol=1e-3)


def test_two_workers_write_the_same_items(binarized):
    root, _ = binarized
    port2 = root / "port2"
    port2.mkdir()
    os.symlink(root / "port" / "spk_emb", port2 / "spk_emb")
    summary = _port_cli(root, "port2", "PopBuTFyENSpkEMBinarizer", ",ds_workers=2")
    assert summary["items"] == {"valid": 2, "test": 2, "train": 4}
    assert summary["stage_seconds"]["dtw_align"] > 0  # reported by the workers
    for prefix in ("train", "test"):
        for a, b in zip(_items(root, "port2", prefix), _items(root, "port", prefix)):
            assert a["item_name"] == b["item_name"]
            for key in ITEM_KEYS[:-1]:
                np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a["multi_spk_emb"][0], b["multi_spk_emb"][0])


def test_dataset_collates_the_port_split(binarized):
    root, _ = binarized
    from neuralsvb_torch.data.datasets import MultiSpkEmbDataset
    hp = dict(_hp(root, "port"), max_frames=400, frames_multiple=4,
              pitch_norm="standard", use_uv=True, infer=False, num_test_samples=0,
              min_frames=0, normalize_pitch=False, seed=1234, sort_by_len=True)
    ds = MultiSpkEmbDataset("train", hp=hp)
    assert len(ds) == 4
    batch = ds.collater([ds[i] for i in ds.ordered_indices()[:2]])
    assert batch["mels"].shape[0] == 2 and batch["mels"].shape[2] == 80
    assert batch["a2p_f0_alignment"].shape == batch["prof_pitch"].shape
    assert batch["multi_spk_emb"].shape == (2, 5, 256)
    assert 100 < hp["f0_mean"] < 400


@pytest.mark.parametrize("change,error", [
    ({"device": None}, ValueError),                     # device is required
    ({"device": "cuda"}, RuntimeError),                 # and must exist
    ({"text_labels": True}, NotImplementedError),       # the pairs have no text branch
])
def test_binarizer_refuses(tmp_path, change, error):
    from neuralsvb_torch.data.binarizer import PopBuTFyENSpkEMBinarizer
    from neuralsvb_torch.hparams import hparams_scope
    if change.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present here")
    (tmp_path / "processed" / "data" / "p1").mkdir(parents=True)
    if change.pop("text_labels", False):
        (tmp_path / "processed" / "data" / "p1" / "A#singing#S_Amateur_0.wav").touch()
        (tmp_path / "processed" / "text_labels" / "p1").mkdir(parents=True)
        (tmp_path / "processed" / "text_labels" / "p1" / "A#singing#S_Amateur_0.txt") \
            .write_text("la la")
    with hparams_scope({**_hp(tmp_path, "out"), "device": "cpu", **change}):
        with pytest.raises(error):
            PopBuTFyENSpkEMBinarizer().process()
