"""The evaluation harnesses of the port against the JAX package: the
metrics (``utils/metrics.py``), the MCD harness (``tasks/mcd_eval.py``),
the six aligners and ``NInterpo`` (``ops/dtw.py``) and the
pitch-alignment harness (``tasks/pitch_alignment_task.py``).

The metrics are host float64 on both sides, so the numbers are equal to
the last bit; the aligners' alignments and the harnesses' accuracies are
equal exactly (the JAX package's own tests of these modules check that they
run: ``tests/test_dtw.py:93-102``, ``tests/test_tasks2.py:115-122``).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

ALIGNERS = ("SADTW", "EHSADTW", "NaiveDTW", "ZMNaiveDTW", "NNaiveDTW", "LoNDTW")


def _contour(rng, T, base):
    t = np.arange(T)
    f0 = base * (1 + 0.08 * np.sin(t / (5 + rng.rand() * 4)) + 0.02 * rng.randn(T))
    gaps = rng.rand(T) < 0.04
    f0[np.convolve(gaps, np.ones(5), "same") > 0] = 0.0
    f0[:3] = 0.0
    return f0


def test_metrics_match_jax():
    from neuralsvb_tpu.utils import metrics as jm
    from neuralsvb_torch.utils import metrics as tm
    rng = np.random.RandomState(0)
    a, b = rng.randn(50, 80) * 0.5 - 3, rng.randn(47, 80) * 0.5 - 3
    for n in (13, 25):
        assert tm.mel_cepstral_distortion(a, b, n) == jm.mel_cepstral_distortion(a, b, n)
    assert tm.mel_cepstral_distortion(a, a) == 0.0
    assert tm.laplace_var(a) == jm.laplace_var(a)


def test_mcd_eval_dirs_match_jax(tmp_path, capsys):
    from neuralsvb_tpu.tasks.mcd_eval import evaluate_dirs as jeval
    from neuralsvb_torch.tasks import mcd_eval
    rng = np.random.RandomState(1)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    for i in range(3):
        mel = rng.randn(40 + 8 * i, 80).astype(np.float32) - 3
        np.save(tmp_path / "a" / f"[{i:06d}][item{i}].npy", mel)
        np.save(tmp_path / "b" / f"[{i:06d}][item{i}].npy",
                mel[: 38 + 8 * i] + 0.05 * rng.randn(38 + 8 * i, 80).astype(np.float32))
    np.save(tmp_path / "a" / "only_a.npy", np.zeros((4, 80)))
    want = jeval(str(tmp_path / "a"), str(tmp_path / "b"))
    jax_lines = capsys.readouterr().out
    got = mcd_eval.main(["--dir_a", str(tmp_path / "a"), "--dir_b", str(tmp_path / "b")])
    assert got == want and 0 < got < 5
    assert capsys.readouterr().out == jax_lines
    (tmp_path / "c").mkdir()
    with pytest.raises(SystemExit, match="no common"):
        mcd_eval.evaluate_dirs(str(tmp_path / "a"), str(tmp_path / "c"))


@pytest.mark.parametrize("S, T, seed", [(90, 120, 0), (130, 100, 1), (70, 70, 2)])
def test_aligners_match_jax(S, T, seed):
    from neuralsvb_tpu.ops import dtw as jd
    from neuralsvb_torch.ops import dtw as td
    rng = np.random.RandomState(seed)
    src, tgt = _contour(rng, S, 180.0), _contour(rng, T, 220.0)
    inputs = np.repeat(np.arange(1, S // 6 + 2), 6)[:S]
    assert sorted(td.ALIGN_FUNCS) == sorted(jd.ALIGN_FUNCS) == sorted(ALIGNERS)
    for name in ALIGNERS:
        out_t, al_t = td.ALIGN_FUNCS[name](src, tgt, inputs, torch.device("cpu"))
        out_j, al_j = jd.ALIGN_FUNCS[name](src, tgt, inputs)
        np.testing.assert_array_equal(al_t, al_j, err_msg=name)
        np.testing.assert_array_equal(out_t, out_j, err_msg=name)
        assert al_t.shape == (T,) and (np.diff(al_t) >= 0).all()
    np.testing.assert_array_equal(td.get_local_context(src, 8), jd.get_local_context(src, 8))
    mel = rng.randn(S, 4)
    for a, b in zip(td.NInterpo(src, tgt, src, inputs, mel), jd.NInterpo(src, tgt, src, inputs, mel)):
        np.testing.assert_array_equal(a, b)
    assert td.NInterpo(src, tgt, src)[1:] == (None, None)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Two splits of four pairs each: ``test`` with phone alignments on both
    sides (the mel2ph branch), ``valid`` without (the f0 proxy)."""
    from neuralsvb_tpu.data.indexed_dataset import IndexedDatasetBuilder
    root = tmp_path_factory.mktemp("align_bin")
    rng = np.random.RandomState(5)
    for split, with_m2p in (("test", True), ("valid", False)):
        b = IndexedDatasetBuilder(str(root / split))
        for i in range(4):
            Ta, Tp = 100 + 10 * i, 110 + 5 * i
            item = {"item_name": f"{split}{i}", "f0": _contour(rng, Ta, 170.0),
                    "prof_f0": _contour(rng, Tp, 200.0)}
            if with_m2p:
                item["mel2ph"] = np.repeat(np.arange(1, 20), 8)[:Ta]
                item["prof_mel2ph"] = np.repeat(np.arange(1, 20), 9)[:Tp]
            b.add_item(item)
        b.finalize()
    return root


@pytest.mark.parametrize("split", ["test", "valid"])
def test_pitch_alignment_harness_matches_jax(packed, split, capsys):
    from neuralsvb_tpu.tasks.pitch_alignment_task import evaluate as jeval
    from neuralsvb_torch.tasks import pitch_alignment_task as tp
    saved = dict(jhparams)
    jhparams.clear()
    jhparams.update(binary_data_dir=str(packed))
    try:
        want = jeval(split, ALIGNERS, n_workers=2)
    finally:
        jhparams.clear()
        jhparams.update(saved)
    jax_lines = capsys.readouterr().out
    with hparams_scope(dict(binary_data_dir=str(packed), device="cpu")):
        got = tp.evaluate(split, ALIGNERS, n_workers=2)
    out = capsys.readouterr().out
    assert got == want
    assert out.startswith(jax_lines) and "| pitch alignment summary:" in out
    assert tp.THRESHOLD == 0.3


def test_pitch_alignment_cli(packed):
    """``align_funcs``/``align_split`` through the CLI's hparams."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = packed / "cfg.yaml"
    cfg.write_text(f"binary_data_dir: {packed}\n")
    out = subprocess.run(
        [sys.executable, "-m", "neuralsvb_torch.tasks.pitch_alignment_task", "--config",
         str(cfg), "--hparams", "align_funcs=LoNDTW|SADTW,align_split=valid,device=cpu"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "| LoNDTW [valid] avg=" in out.stdout and "| SADTW [valid] avg=" in out.stdout


def test_chi2_launch_count_survives_threads():
    """The pitch-alignment harness launches χ² from a thread pool: 32
    threads counting 2,000 launches each, with a short switch interval,
    lose none."""
    import sys
    import threading
    from neuralsvb_torch.ops import chi2
    saved, interval = chi2.chi2_dist.launches, sys.getswitchinterval()
    chi2.chi2_dist.launches = 0
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [chi2.count_launch() for _ in range(2000)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert chi2.chi2_dist.launches == 32 * 2000
    finally:
        sys.setswitchinterval(interval)
        chi2.chi2_dist.launches = saved
