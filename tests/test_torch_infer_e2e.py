"""The port's inference CLI end to end on the CPU at tiny widths, and the
port's slice against the JAX slice on the same weights.

A 2-item packed test split (the port's builder), a vocoder directory
(config.yaml + torch checkpoint) and an SVBVAE checkpoint are written to a
temporary directory; ``python -m neuralsvb_torch.tasks.run --infer`` must
write the five wav and mel directories with wav length = frames x hop.
Then, for one item, the port's ``mel_out`` and vocoded a2p wav are held
against ``neuralsvb_tpu`` at zero noise (5e-4 for mel_out, 1e-4 for wav).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from tests.test_torch_support import agree, jax_zero_noise, seeded  # noqa: E402
from tests.test_torch_svb_vae import TINY, jax_svbvae  # noqa: E402

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.models.hifigan import HifiGanGenerator  # noqa: E402
from neuralsvb_torch.models.svb_vae import SVBVAE  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIBLING = os.path.join(REPO, "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml")
VOC = dict(upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
           upsample_initial_channel=32, resblock="1",
           resblock_kernel_sizes=[3, 7, 11],
           resblock_dilation_sizes=[[1, 3, 5]] * 3)
HP = dict(hidden_size=32, latent_size=8, fvae_enc_dec_hidden=16, fvae_kernel_size=5,
          fvae_enc_n_layers=2, fvae_dec_n_layers=2, asr_enc_layers=1,
          collate_bucket_quant=16, zero_noise=True)
FRAMES = (72, 64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    data, voc, work = root / "data", root / "voc", root / "work"
    write_synthetic_split(str(data), FRAMES, seed=3)
    voc.mkdir()
    (voc / "config.yaml").write_text(yaml.safe_dump(VOC))
    gen = seeded(lambda: HifiGanGenerator(**VOC), 11)
    torch.save({"state_dict": {"model_gen": gen.state_dict()}},
               voc / "model_ckpt_steps_100.ckpt")
    work.mkdir()
    model = seeded(lambda: SVBVAE(100, **TINY), 12)
    torch.save({"state_dict": {"model": model.state_dict()}, "global_step": 5},
               work / "model_ckpt_steps_5.ckpt")
    cfg = dict(HP, base_config=[SIBLING], binary_data_dir=str(data),
               vocoder_ckpt=str(voc))
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return root, model


def _run_cli(root):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "neuralsvb_torch.tasks.run", "--config",
         str(root / "cfg.yaml"), "--infer", "--hparams",
         f"device=cpu,work_dir={root / 'work'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_cli_writes_the_wav_tree(setup):
    root, _ = setup
    out = _run_cli(root)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "| Restored ckpt:" in out.stdout
    # CPU tensors take the plain cluster: the kernel is never launched
    assert '"resblock_conv1d_launches": 0' in out.stdout
    gen = root / "work" / "generated_5_"
    for key in ("gt_a", "gt_p", "a2a", "p2p", "a2p"):
        wavs = sorted(glob.glob(str(gen / "wavs" / f"{key}_wavout" / "*.wav")))
        mels = sorted(glob.glob(str(gen / "mels" / f"{key}_mel" / "*.npy")))
        assert len(wavs) == len(mels) == 2, key
        for w, m in zip(wavs, mels):
            with wave.open(w) as f:
                n = f.getnframes()
                assert f.getframerate() == 22050
            assert n == np.load(m).shape[0] * 128, (key, n)


def test_slice_matches_jax(setup):
    """Item 0 through the port's task objects vs the JAX model + vocoder."""
    from neuralsvb_tpu.hparams import hparams_scope as jax_scope
    from neuralsvb_tpu.ops.pitch_utils import denorm_f0 as jax_denorm
    from neuralsvb_tpu.vocoders.hifigan import HifiGAN as JHifiGAN
    from neuralsvb_torch.hparams import hparams_scope, set_hparams
    from neuralsvb_torch.ops.pitch_utils import denorm_f0
    from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask
    root, model = setup
    hp = set_hparams(config=str(root / "cfg.yaml"),
                     hparams_str=f"device=cpu,work_dir={root / 'work'}",
                     print_hparams=False, global_hparams=False)
    with hparams_scope(hp) as h:
        task = SVBVAEMleTask()
        task.build_model()
        task.restore()
        batch = next(iter(task.test_dataloader()))
        out = task.forward(task._prep_batch(batch))
        task.test_start()
        Tp = int(batch["prof_mel_lengths"][0])
        f0_t = denorm_f0(torch.as_tensor(batch["prof_f0"]),
                         torch.as_tensor(batch["prof_uv"]), h)[0, :Tp]
        mel_t = out["a2p"]["mel_out"][0, :Tp]
        wav_t = task.vocoder.spec2wav(mel_t, f0=f0_t, zero_noise=True)
        jhp = dict(h)
    task.saving_result_pool.close()

    jm, params, stats = jax_svbvae(model, dict_size=100)
    args = (batch["mels"], batch["prof_mels"], batch["pitch"].astype(np.int32),
            batch["prof_pitch"].astype(np.int32), batch["multi_spk_emb"][:, 0],
            batch["a2p_f0_alignment"].astype(np.int32))
    f0_j = jax_denorm(batch["prof_f0"], batch["prof_uv"], jhp)[0, :Tp]
    agree(f0_t, f0_j, 1e-4, "denormalized f0")
    with jax_scope(jhp), jax_zero_noise():
        rj = jm.apply({"params": params, "batch_stats": stats}, *args,
                      concurrent_ways=("a2a", "p2p", "a2p"),
                      rngs={"noise": jax.random.PRNGKey(0)})
        mel_j = np.asarray(rj["a2p"]["mel_out"])[0, :Tp]
        wav_j = JHifiGAN(jhp).spec2wav(mel_j, f0=f0_j)
    agree(mel_t, mel_j, 5e-4, "a2p mel_out")
    agree(wav_t, wav_j, 1e-4, "a2p wav")
