"""Shared set-up of the harness's CPU tests: tiny widths and short traffic,
the port on the CPU against the frozen reference."""

import json

import pytest
import torch

from svb_bench import harness, run

TINY = {
    "a2p_songs": {"hparams": dict(hidden_size=32, latent_size=8, fvae_enc_dec_hidden=16,
                                  fvae_enc_n_layers=2, fvae_dec_n_layers=2, asr_enc_layers=1),
                  "vocoder": dict(upsample_initial_channel=16),
                  "traffic": dict(prof_seconds=[0.3, 0.6], deck=4, trace_requests=2,
                                  check_requests=3)},
    "vocoder_train": {"hparams": dict(upsample_initial_channel=16, max_samples=2048,
                                      max_sentences=2),
                      "traffic": dict(items=4, item_seconds=[0.5, 1.0], trace_steps=1)},
}
TINY["svb_train"] = {"hparams": dict(TINY["a2p_songs"]["hparams"], disc_win_num=2,
                                     mel_disc_hidden_size=8, max_tokens=600),
                     "traffic": dict(deck=6, prof_seconds=[0.8, 1.2], trace_steps=1)}


def bench():
    """``BENCHMARK.json`` with the held cells (``held_cells.json``)."""
    return harness.with_held(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))


def run_tiny(workload, seed=2 ** 31 + 12345, trace=0, control=0, seconds=0.5):
    """One run of ``workload`` at tiny widths on the CPU: (line, Result)."""
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), "--control", str(control)])
    return run.run_cell(args, device=torch.device("cpu"), require_cuda=False,
                        overrides=TINY[workload], bench=bench())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)
