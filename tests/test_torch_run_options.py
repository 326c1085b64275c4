"""The CLI's output under torchrun and three options of the JAX package that
the port honours: ``drop_last_batch``, ``valid_monitor_key`` with
``valid_monitor_mode``, and ``save_codes``.

- A launched world (torchrun's ``RANK``/``WORLD_SIZE`` in the environment):
  ``tasks/run.py`` line-buffers stdout, so each line reaches the ranks'
  shared pipe in one ``write``, and only rank 0 prints the ``| Hparams:``
  dump (over 4 KB, so no single pipe write could carry it whole).
- ``drop_last_batch``: the batches of a shuffled loader equal the JAX
  ``build_dataloader``'s, over one and two data-parallel ranks (the
  ``_Sized`` pattern of ``tests/test_torch_ddp.py``).
- ``valid_monitor_key``/``valid_monitor_mode``: over a sequence of
  validation results, the checkpoints each trainer marks best are the same.
- ``save_codes``: the snapshot holds the files the JAX entry's holds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_ddp import _Sized  # noqa: E402

from neuralsvb_tpu.hparams import hparams as jhparams  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_hparams():
    """The JAX package's global hparams for the test, restored after."""
    saved = dict(jhparams)

    def use(hp):
        jhparams.clear()
        jhparams.update(hp)
    yield use
    jhparams.clear()
    jhparams.update(saved)


@pytest.mark.parametrize("rank", [0, 1])
def test_launched_stdout_is_line_buffered_and_hparams_print_on_rank0(rank):
    """As torchrun starts a rank: ``python -u`` with ``RANK``/``WORLD_SIZE``."""
    code = ("import sys\n"
            "from neuralsvb_torch.tasks import run\n"
            "from neuralsvb_torch.hparams import set_hparams\n"
            "run.line_buffer_launched_stdout()\n"
            "print('| line_buffering', sys.stdout.line_buffering, sys.stdout.write_through)\n"
            "set_hparams(config='egs/egs_bases/tts/fs2_adv_torch.yaml')\n")
    env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE="2",
               LOCAL_RANK=str(rank))
    out = subprocess.run([sys.executable, "-u", "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "| line_buffering True False" in out.stdout
    dump = [ln for ln in out.stdout.splitlines() if ln.startswith("| Hparams:")]
    assert len(dump) == (1 if rank == 0 else 0)
    if rank == 0:
        assert len(dump[0]) > 4096  # more than one atomic pipe write


def test_two_launched_ranks_keep_their_lines_whole(tmp_path):
    """Two ``python -u`` ranks, started together at a file barrier, print
    4,000 lines of about 700 bytes each, in three pieces per ``print``, into
    one pipe at once: every line arrives whole (the merged stdout that the
    torchrun test and smoke phase 25 parse)."""
    code = ("import json, os, time\n"
            "from neuralsvb_torch.tasks import run\n"
            "run.line_buffer_launched_stdout()\n"
            "r, d = os.environ['RANK'], os.environ['BARRIER']\n"
            "open(os.path.join(d, r), 'w').close()\n"
            "while len(os.listdir(d)) < 2:\n"
            "    time.sleep(0.001)\n"
            "for i in range(4000):\n"
            "    print('| line', json.dumps({'rank': r, 'i': i, 'pad': r * 700}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2", BARRIER=str(tmp_path))
    r_fd, w_fd = os.pipe()
    procs = [subprocess.Popen([sys.executable, "-u", "-c", code], cwd=REPO,
                              env=dict(env, RANK=str(r)), stdout=w_fd)
             for r in (0, 1)]
    os.close(w_fd)
    with os.fdopen(r_fd) as f:
        lines = f.read().splitlines()
    for p in procs:
        assert p.wait(timeout=120) == 0
    seen = {"0": 0, "1": 0}
    for line in lines:
        assert line.startswith("| line {"), line[:80]
        seen[json.loads(line[len("| line "):])["rank"]] += 1
    assert seen == {"0": 4000, "1": 4000}


def test_unlaunched_stdout_keeps_its_buffering():
    code = ("import sys\n"
            "from neuralsvb_torch.tasks import run\n"
            "run.line_buffer_launched_stdout()\n"
            "print(sys.stdout.line_buffering)\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(env, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"  # a pipe, block-buffered as before


@pytest.mark.parametrize("max_tokens, max_sentences, by_size, n_devices", [
    (400, 5, True, 1), (None, 3, False, 1), (1000, None, True, 1), (400, 5, True, 2),
    (300, 4, True, 2), (100000, 100, True, 1)])
def test_drop_last_batch_matches_jax(jax_hparams, max_tokens, max_sentences, by_size,
                                     n_devices):
    """Shuffled loaders keep their full batches (all of them when none is
    full: the last case); an unshuffled one keeps every batch."""
    from neuralsvb_tpu.tasks.base_task import BaseTask as JBase
    from neuralsvb_torch.tasks.base_task import BaseTask as TBase
    sizes = np.random.RandomState(3).randint(20, 120, 23)
    hp = dict(seed=1234, ds_workers=0, mesh_shape="", drop_last_batch=True)
    for shuffle in (True, False):
        jax_hparams(hp)
        want = JBase().build_dataloader(_Sized(sizes), shuffle, max_tokens, max_sentences,
                                        use_batch_by_size=by_size,
                                        n_devices=n_devices).batches
        with hparams_scope(hp):
            got = TBase().build_dataloader(_Sized(sizes), shuffle, max_tokens, max_sentences,
                                           use_batch_by_size=by_size,
                                           n_devices=n_devices).batches
        assert [list(map(int, b)) for b in got] == [list(map(int, b)) for b in want]
    with hparams_scope(dict(hp, drop_last_batch=False)):
        kept = TBase().build_dataloader(_Sized(sizes), True, max_tokens, max_sentences,
                                        use_batch_by_size=by_size, n_devices=n_devices).batches
    assert sum(map(len, kept)) >= sum(map(len, got))


class _ValTask:
    """Validation results from a list, one per evaluation."""

    device = torch.device("cpu")

    def __init__(self, results):
        self.results = list(results)

    def val_dataloader(self):
        return [{"x": 1}]

    def validation_step(self, batch, i):
        return {"nsamples": 1}

    def validation_end(self, outputs):
        return dict(self.results.pop(0), tb_log={})


RESULTS = [{"val_loss": 3.0, "val_mel": 0.5}, {"val_loss": 2.0, "val_mel": 0.7},
           {"val_loss": 2.5, "val_mel": 0.2}, {"val_loss": 1.0, "val_mel": 0.9},
           {"val_loss": 1.5, "val_mel": 0.1}]


@pytest.mark.parametrize("key, mode", [("val_loss", "min"), ("val_loss", "max"),
                                       ("val/mel", "min"), ("val/mel", "max"),
                                       ("val/absent", "max")])
def test_valid_monitor_key_matches_jax(tmp_path, key, mode):
    from neuralsvb_tpu.training.trainer import Trainer as JTrainer
    from neuralsvb_torch.training.trainer import Trainer as TTrainer

    def run(trainer):
        marks = []
        trainer._save = lambda task, is_best=False: marks.append(is_best)
        trainer.log_metrics = lambda *a, **k: None
        task = _ValTask(RESULTS)
        for _ in RESULTS:
            trainer.run_evaluation(task)
        return marks, trainer.best_val

    want = run(JTrainer(str(tmp_path), monitor_key=key, monitor_mode=mode))
    got = run(TTrainer(str(tmp_path), monitor_key=key, monitor_mode=mode))
    assert got == want
    with hparams_scope({"work_dir": str(tmp_path), "val_check_interval": 2,
                        "tb_log_interval": 1, "max_updates": 1, "num_ckpt_keep": 1,
                        "save_best": True, "num_sanity_val_steps": 0,
                        "valid_monitor_key": key, "valid_monitor_mode": mode}) as hp:
        t = TTrainer.from_hparams(hp)
    assert (t.monitor_key, t.monitor_mode) == (key, mode)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_save_codes_matches_jax(tmp_path, jax_hparams, capsys):
    from neuralsvb_tpu.tasks import run as jrun
    from neuralsvb_torch.tasks import run as trun
    src = tmp_path / "src"
    (src / "pkg" / "__pycache__").mkdir(parents=True)
    (src / "pkg" / "a.py").write_text("x = 1\n")
    (src / "pkg" / "b.pyc").write_bytes(b"\0")
    (src / "pkg" / "__pycache__" / "c.pyc").write_bytes(b"\0")
    (src / "conf").mkdir()
    (src / "conf" / "c.yaml").write_text("a: 1\n")
    dirs = [str(src / "pkg"), str(src / "conf"), str(src / "missing")]
    jax_hparams({"save_codes": dirs, "work_dir": str(tmp_path / "jax")})
    jrun._save_codes()
    with hparams_scope({"save_codes": dirs, "work_dir": str(tmp_path / "port")}):
        trun.save_codes()
    (j_ts,), (t_ts,) = (os.listdir(tmp_path / w / "codes") for w in ("jax", "port"))
    want = _tree(tmp_path / "jax" / "codes" / j_ts)
    assert want == ["conf/c.yaml", "pkg/a.py"]
    assert _tree(tmp_path / "port" / "codes" / t_ts) == want
    assert f"| Saved codes to {tmp_path / 'port' / 'codes' / t_ts}" in capsys.readouterr().out
    with hparams_scope({"save_codes": [], "work_dir": str(tmp_path / "none")}):
        trun.save_codes()
    assert not (tmp_path / "none").exists()
