"""The training logger: the scalars the JAX package writes to TensorBoard,
as JSON lines, and its validation audio as wav files, under
``work_dir/lightning_logs/version_{N}/`` (N the first free number).
Figures are not written."""

from __future__ import annotations

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
