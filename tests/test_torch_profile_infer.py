"""``profile_infer``: the flagship's ``--infer`` prints the JAX package's
``| profile_infer: N utts (M batches), Xs audio in Ys wall -> RTF r`` line
through ``RTFMeter`` when the hparam is on, and no such line when it is
off, in both packages.

Each package's ``--infer`` entry (``set_hparams`` + ``tasks.run.run_task``,
what the CLI runs after parsing its arguments) runs in this process on the
CPU over the same 3-item packed test split at tiny widths, two items per
batch, with random-init vocoders. The line's counts (utterances, batches
and audio seconds) must be equal; the wall time is each run's own.
"""

from __future__ import annotations

import contextlib
import io
import os
import re

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = "egs/datasets/audio/PopBuTFy/vae_global_mle_eng{}.yaml"
VOC = dict(upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
           upsample_initial_channel=16, resblock="1", resblock_kernel_sizes=[3],
           resblock_dilation_sizes=[[1, 3]])
HP = dict(hidden_size=32, latent_size=8, fvae_enc_dec_hidden=16, fvae_kernel_size=5,
          fvae_enc_n_layers=2, fvae_dec_n_layers=2, asr_enc_layers=1,
          collate_bucket_quant=16, zero_noise=True, pretrain_asr_ckpt="",
          infer_batch_size=2)
LINE = re.compile(r"^\| profile_infer: (\d+) utts \((\d+) batches\), ([\d.]+)s audio in "
                  r"([\d.]+)s wall -> RTF ([\d.]+)$", re.M)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile_infer")
    write_synthetic_split(str(root / "data"), (64, 64, 80), seed=3)
    (root / "voc").mkdir()
    (root / "voc" / "config.yaml").write_text(yaml.safe_dump(VOC))
    for pkg, suffix in (("jax", ""), ("torch", "_torch")):
        cfg = dict(HP, base_config=[os.path.join(REPO, RECIPE.format(suffix))],
                   binary_data_dir=str(root / "data"), vocoder_ckpt=str(root / "voc"))
        (root / f"{pkg}.yaml").write_text(yaml.safe_dump(cfg))
    return root


def run_jax(root, on):
    from neuralsvb_tpu.hparams import hparams, set_hparams
    from neuralsvb_tpu.tasks.run import run_task
    set_hparams(config=str(root / "jax.yaml"),
                hparams_str=f"work_dir={root / 'jax_work'},profile_infer={on}",
                print_hparams=False)
    hparams["infer"] = True
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_task()
    return out.getvalue()


def run_port(root, on):
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.tasks.run import run_task
    h = set_hparams(config=str(root / "torch.yaml"),
                    hparams_str=f"device=cpu,work_dir={root / 'torch_work'},profile_infer={on}",
                    print_hparams=False, global_hparams=False)
    h["infer"] = True
    out = io.StringIO()
    with hparams_scope(h), contextlib.redirect_stdout(out):
        run_task()
    return out.getvalue()


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_profile_infer_line_matches_jax(root, on, monkeypatch):
    monkeypatch.chdir(REPO)  # the recipes' base_config paths are relative
    jax_out, port_out = run_jax(root, on), run_port(root, on)
    jax_lines, port_lines = LINE.findall(jax_out), LINE.findall(port_out)
    assert "| infer summary:" in port_out  # printed either way (the smoke parses it)
    if not on:
        assert jax_lines == port_lines == []
        return
    assert len(jax_lines) == len(port_lines) == 1, (jax_out[-2000:], port_out[-2000:])
    (j_utts, j_batches, j_audio, _, _), (utts, batches, audio, wall, rtf) = \
        jax_lines[0], port_lines[0]
    assert (utts, batches, audio) == (j_utts, j_batches, j_audio) == ("3", "2", audio)
    assert float(audio) > 0 and float(wall) > 0 and float(rtf) > 0
