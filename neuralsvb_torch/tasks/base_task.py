"""Task base class and loader plumbing; port of
``neuralsvb_tpu/tasks/base_task.py`` (reference: tasks/base_task.py:27-355).

A task owns model construction, its dataloaders and the per-batch steps;
``training/trainer.py`` owns the training loop, checkpoints and the logger.
``start`` runs ``Trainer.fit`` or, with ``--infer``, the inference loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..data.batching import batch_by_size
from ..hparams import hparams


class DataLoaderLite:
    """Collated numpy batches over fixed index batches. ``endless`` repeats
    the batches, reshuffling their order each pass when ``shuffle``, from a
    ``RandomState(seed)``; ``prefetch > 0`` collates that many batches ahead
    on a daemon thread."""

    def __init__(self, dataset, batches: List[List[int]], endless: bool = False,
                 shuffle: bool = False, seed: int = 1234, prefetch: int = 0):
        self.dataset = dataset
        self.batches = batches
        self.endless = endless
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.batches)

    def _iter_sync(self) -> Iterator[Dict]:
        while True:
            order = list(range(len(self.batches)))
            if self.shuffle:
                self.rng.shuffle(order)
            for bi in order:
                yield self.dataset.collater([self.dataset[i] for i in self.batches[bi]])
            if not self.endless:
                return

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._iter_sync()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            try:
                for b in self._iter_sync():
                    q.put(b)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)
            q.put(done)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            b = q.get()
            if b is done:
                return
            if isinstance(b, BaseException):
                raise b
            yield b


@contextlib.contextmanager
def no_grad_for(params):
    """Take ``params`` out of autograd for the block (no weight gradients
    are computed for them)."""
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, r in zip(params, saved):
            p.requires_grad_(r)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The ``torch.Generator`` of a training step's random draws, seeded by
    (seed, step): a resumed run draws what the uninterrupted run draws."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed + 1, step]).generate_state(1)[0]))
    return g


def clip_gradients(params, max_norm: float, clip_value: float = 0.0) -> None:
    """optax's ``clip(clip_value)`` then ``clip_by_global_norm(max_norm)``, in
    place: the gradients scale by max/norm only when norm > max (torch's
    ``clip_grad_norm_`` scales by max/(norm + 1e-6) whenever it clips)."""
    grads = [p.grad for p in params]
    if clip_value > 0:
        for g in grads:
            g.clamp_(-clip_value, clip_value)
    if max_norm > 0:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)


def mesh_devices(mesh_shape) -> int:
    """The device count a ``mesh_shape`` such as ``data:4,model:2`` names."""
    return int(np.prod([int(p.split(":")[1]) for p in str(mesh_shape or "").split(",")
                        if ":" in p] or [1]))


def np_rng_state(rng: np.random.RandomState) -> dict:
    """A numpy stream's state as tensors and primitives, which
    ``torch.load(weights_only=True)`` reads back."""
    st = rng.get_state()
    return {"keys": torch.from_numpy(st[1].astype(np.int64)), "pos": int(st[2]),
            "has_gauss": int(st[3]), "cached_gaussian": float(st[4])}


def set_np_rng_state(rng: np.random.RandomState, r: dict) -> None:
    rng.set_state(("MT19937", r["keys"].numpy().astype(np.uint32), r["pos"],
                   r["has_gauss"], r["cached_gaussian"]))


def copy_parameters(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd``'s tensors into ``module``'s parameters of the same name
    and shape; a parameter whose shape differs, or that ``sd`` lacks, keeps
    its value. Buffers (BatchNorm statistics) are not touched, as the JAX
    package's ``load_sub_params`` loads params only."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in sd and sd[name].shape == p.shape:
                p.copy_(sd[name])
            elif name in sd:
                print(f"| skip mismatched {name}: {tuple(sd[name].shape)} vs "
                      f"{tuple(p.shape)}")


class BaseTask:
    def __init__(self):
        self.hparams = hparams
        self.global_step = 0
        self.current_epoch = 0
        self.trainer = None
        self.logger = None
        self.grad_hook = None  # (name, params) after backward, before clipping

    def _dict_size(self) -> int:
        """The ASR's token vocabulary: ``len(phone_set.json) + 10``, else 100."""
        fn = os.path.join(hparams["binary_data_dir"], "phone_set.json")
        if os.path.exists(fn):
            with open(fn) as f:
                return len(json.load(f)) + 10
        print(f"| WARNING: {fn} missing; defaulting ASR dict size to 100.")
        return 100

    def train_phase(self, step: int):
        """The label under which the trainer times step ``step``."""
        return "train"

    def update(self, name, opt, params, total, lr, max_norm, clip_value=0.0):
        """Backward, then clip and the optimizer's step at ``lr``; a
        parameter without a gradient steps with a zero one, as an optax
        chain steps every leaf."""
        opt.zero_grad(set_to_none=True)
        if torch.is_tensor(total) and total.requires_grad:
            total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_hook is not None:
            self.grad_hook(name, params)
        clip_gradients(params, float(max_norm or 0), float(clip_value or 0))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def build_model(self):
        raise NotImplementedError

    def restore(self) -> int:
        """Load the newest checkpoint of ``work_dir``; returns its step."""
        raise NotImplementedError

    def build_dataloader(self, dataset, shuffle: bool = False, max_tokens=None,
                         max_sentences=None, endless: bool = False,
                         use_batch_by_size: bool = True) -> DataLoaderLite:
        indices = dataset.ordered_indices()
        if use_batch_by_size:
            batches = batch_by_size(indices, dataset.num_tokens, max_tokens=max_tokens,
                                    max_sentences=max_sentences)
        else:
            ms = max_sentences or 1
            batches = [list(indices[i:i + ms]) for i in range(0, len(indices), ms)]
        prefetch = 4 if shuffle and int(hparams.get("ds_workers", 1) or 0) > 0 else 0
        return DataLoaderLite(dataset, batches, endless=endless, shuffle=shuffle,
                              seed=int(hparams.get("seed", 1234)), prefetch=prefetch)

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

    def validation_end(self, outputs):
        """Sample-weighted means of the validation losses."""
        sums: Dict[str, float] = {}
        n_total = 0
        for out in outputs:
            n = out["nsamples"]
            n_total += n
            for k, v in dict(out["losses"], total_loss=out["total_loss"]).items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
        loss_output = {k: round(v / n_total, 4) for k, v in sums.items()}
        print(f"| Valid results: {loss_output}")
        return {"tb_log": {f"val/{k}": v for k, v in loss_output.items()},
                "val_loss": loss_output["total_loss"]}

    @classmethod
    def start(cls):
        np.random.seed(hparams.get("seed", 1234))
        task = cls()
        if hparams.get("infer"):
            return task.test()
        from ..training.trainer import Trainer
        return Trainer.from_hparams(hparams).fit(task)
