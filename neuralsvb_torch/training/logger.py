"""The training logger: the scalars the JAX package writes to TensorBoard,
as JSON lines, its validation audio as wav files and its validation figures
as PNG files, under ``work_dir/lightning_logs/version_{N}/`` (N the first
free number). Without ``matplotlib`` no figure is drawn: the logger prints
``| figures not written: no matplotlib`` once and ``writes_figures`` is
False."""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np


class JsonLogger:
    def __init__(self, work_dir: str):
        root = os.path.join(work_dir, "lightning_logs")
        os.makedirs(root, exist_ok=True)
        n = 0
        while os.path.exists(os.path.join(root, f"version_{n}")):
            n += 1
        self.log_dir = os.path.join(root, f"version_{n}")
        os.makedirs(os.path.join(self.log_dir, "audio"))
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        self.writes_figures = importlib.util.find_spec("matplotlib") is not None
        if not self.writes_figures:
            print("| figures not written: no matplotlib", flush=True)

    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {k: float(v) for k, v in metrics.items()
               if isinstance(v, (int, float, np.floating, np.integer))}
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({"step": step, **row}) + "\n")

    def add_audio(self, tag: str, wav, step: int, sample_rate: int) -> str:
        from ..ops.audio import save_wav
        path = os.path.join(self.log_dir, "audio", f"{tag}_step{step}.wav")
        save_wav(np.clip(np.asarray(wav, np.float32), -1.0, 1.0), path, sample_rate)
        return path

    def add_figure(self, tag: str, fig, step: int) -> str:
        """Save a matplotlib figure as ``figures/{tag}_step{step}.png`` and
        close it."""
        import matplotlib.pyplot as plt
        d = os.path.join(self.log_dir, "figures")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{tag}_step{step}.png")
        fig.savefig(path)
        plt.close(fig)
        return path
