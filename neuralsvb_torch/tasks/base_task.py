"""Task base class and the inference loop; port of the test path of
``neuralsvb_tpu/tasks/base_task.py`` and ``Trainer.test``
(reference: tasks/base_task.py:27-355).

A task owns model construction, the test dataloader and the per-batch
test step. Training is not ported yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from ..hparams import hparams


class DataLoaderLite:
    """Collated numpy batches over fixed index batches."""

    def __init__(self, dataset, batches: List[List[int]]):
        self.dataset = dataset
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[Dict]:
        for idxs in self.batches:
            yield self.dataset.collater([self.dataset[i] for i in idxs])


class BaseTask:
    def __init__(self):
        self.hparams = hparams
        self.global_step = 0

    def build_model(self):
        raise NotImplementedError

    def restore(self) -> int:
        """Load the newest checkpoint of ``work_dir``; returns its step."""
        raise NotImplementedError

    def build_dataloader(self, dataset, max_sentences: int = 1) -> DataLoaderLite:
        indices = dataset.ordered_indices()
        batches = [list(indices[i:i + max_sentences])
                   for i in range(0, len(indices), max_sentences)]
        return DataLoaderLite(dataset, batches)

    def test_dataloader(self):
        raise NotImplementedError

    def test_start(self):
        pass

    def test_step(self, batch, batch_idx: int):
        raise NotImplementedError

    def test_end(self, outputs):
        return {}

    def test(self):
        """The inference loop (``Trainer.test`` in the JAX package)."""
        self.build_model()
        self.global_step = self.restore()
        self.test_start()
        outputs = []
        for i, batch in enumerate(self.test_dataloader()):
            if batch:
                outputs.append(self.test_step(batch, i))
        return self.test_end(outputs)

    @classmethod
    def start(cls):
        np.random.seed(hparams.get("seed", 1234))
        task = cls()
        if not hparams.get("infer"):
            raise NotImplementedError(
                "training is not ported to PyTorch yet (ROADMAP.md queue 1 "
                "item 6); run with --infer")
        return task.test()
