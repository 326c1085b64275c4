"""Task base class and loader plumbing; port of
``neuralsvb_tpu/tasks/base_task.py`` (reference: tasks/base_task.py:27-355).

A task owns model construction, its dataloaders and the per-batch steps;
``training/trainer.py`` owns the training loop, checkpoints and the logger.
``start`` runs ``Trainer.fit`` or, with ``--infer``, the inference loop.

The optimizer update (``update``) is the JAX package's optax chain: under
data parallelism the gradients are first averaged over the world
(``parallel/ddp.py``), and with ``accumulate_grad_batches: k`` an
``optax.MultiSteps`` counterpart (``training/optim.py``) holds the update
until the k-th micro-step of that optimizer. ``apply_in_dtype`` is the SVB
tasks' ``compute_dtype`` cast at the apply boundary. Under a
``torch.profiler`` session ``update`` records the spans ``update.backward``
(``zero_grad`` and the backward) and ``update.optim`` (the rest), and the
prefetching loader ``data.wait`` around its wait for the next batch
(``utils/profiling.py`` ``span``).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import batch_by_size
from ..hparams import hparams
from ..parallel import ddp
from ..training.optim import MultiSteps
from ..utils.profiling import span


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
            with span("data.wait"):
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


def _cast_floats(tree, src, dst):
    """Every tensor of dtype ``src`` in a nest of dicts, lists and tuples
    cast to ``dst`` (differentiable); the rest passes through."""
    if torch.is_tensor(tree):
        return tree.to(dst) if tree.dtype == src else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, src, dst) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, src, dst) for v in tree)
    return tree


def apply_in_dtype(module: torch.nn.Module, dtype: Optional[torch.dtype], *args,
                   carry: Sequence[str] = (), **kwargs):
    """``module(*args, **kwargs)`` run in ``dtype`` (None: as it is), the
    JAX package's ``compute_dtype`` cast at the apply boundary
    (``neuralsvb_tpu/tasks/svb_vae_task.py:482-536``). Float parameters and
    float tensors among the arguments become ``dtype`` copies: the
    parameters' copies are differentiable, so gradients land on the master
    leaves as the transpose of the JAX cast does. Float buffers (BatchNorm
    statistics) are rounded through ``dtype`` but stay in the master dtype:
    flax's BatchNorm updates its statistics in float32 from the cast ones
    (``models/common.py`` ``_batch_norm``). Float outputs come back in the
    master dtype, and the updated statistics of the buffers whose names
    start with a prefix in ``carry`` are copied back (the JAX step returns
    its mutable ``batch_stats``). Not autocast: the whole body runs in
    ``dtype``, softmax and reductions included; the norms compute their
    statistics in float32, as flax's do."""
    if dtype is None:
        return module(*args, **kwargs)
    master = next(module.parameters()).dtype
    params = {n: p.to(dtype) for n, p in module.named_parameters()
              if p.is_floating_point()}
    bufs = {n: b.to(dtype).to(b.dtype) for n, b in module.named_buffers()
            if b.is_floating_point()}
    out = torch.func.functional_call(module, {**params, **bufs},
                                     _cast_floats(args, master, dtype),
                                     _cast_floats(kwargs, master, dtype))
    if carry:
        with torch.no_grad():
            for n, b in module.named_buffers():
                if n in bufs and n.startswith(tuple(carry)):
                    b.copy_(bufs[n])
    return _cast_floats(out, dtype, master)


def compute_dtype() -> Optional[torch.dtype]:
    """The ``compute_dtype`` hparam: bfloat16, or None (the master dtype)."""
    cdt = hparams.get("compute_dtype")
    if cdt in (None, "", "float32"):
        return None
    if cdt != "bfloat16":
        raise ValueError(f"compute_dtype {cdt!r}: float32 or bfloat16")
    return torch.bfloat16


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
        self.accumulators: Dict[str, MultiSteps] = {}
        # the data-parallel degree; a model axis or a mesh unlike the world raises
        self.n_devices = ddp.data_parallel_size(hparams.get("mesh_shape"))

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

    def build_accumulators(self, groups: Dict[str, list]) -> None:
        """One ``MultiSteps`` per optimizer (``accumulate_grad_batches`` >
        1); each counts the micro-steps of its own optimizer."""
        k = int(hparams.get("accumulate_grad_batches", 1) or 1)
        self.accumulators = ({name: MultiSteps(params, k) for name, params in groups.items()}
                             if k > 1 else {})

    def accumulator_state(self) -> dict:
        return {n: a.state_dict() for n, a in self.accumulators.items()}

    def load_accumulator_state(self, ckpt: dict) -> None:
        for n, st in (ckpt.get("accumulators") or {}).items():
            if n in self.accumulators:
                self.accumulators[n].load_state_dict(st)

    def update(self, name, opt, params, total, lr, max_norm, clip_value=0.0):
        """Backward, then clip and the optimizer's step at ``lr``; a
        parameter without a gradient steps with a zero one, as an optax
        chain steps every leaf. Under data parallelism the gradients are
        the world's mean (the global batch's gradient); under accumulation
        a micro-step before the k-th only folds them into the running mean
        and leaves the parameters and the optimizer's state untouched."""
        with span("update.backward"):
            opt.zero_grad(set_to_none=True)
            if torch.is_tensor(total) and total.requires_grad:
                total.backward()
        with span("update.optim"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            ddp.average_gradients(params)
            if self.grad_hook is not None:
                self.grad_hook(name, params)
            acc = self.accumulators.get(name)
            if acc is not None and not acc.accumulate():
                return
            clip_gradients(params, float(max_norm or 0), float(clip_value or 0))
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()

    def training_step(self, batch, step: int, optimizer_idx: int):
        """(total loss, logs) of optimizer ``optimizer_idx`` at ``step``, or
        None when it is idle (``_training_step``), inside ``ddp.sharded``
        over the task's data-parallel world: the task takes its rows of the
        global batch and its losses are the global batch's."""
        with ddp.sharded(self.n_devices):
            return self._training_step(ddp.local_batch(batch), step, optimizer_idx)

    def _training_step(self, batch, step: int, optimizer_idx: int):
        raise NotImplementedError

    def build_model(self):
        raise NotImplementedError

    def restore(self) -> int:
        """Load the newest checkpoint of ``work_dir``; returns its step."""
        raise NotImplementedError

    def build_dataloader(self, dataset, shuffle: bool = False, max_tokens=None,
                         max_sentences=None, endless: bool = False,
                         use_batch_by_size: bool = True, n_devices: int = 1) -> DataLoaderLite:
        """Index batches of ``dataset``; over ``n_devices`` data-parallel
        ranks the JAX package's global budget: ``max_tokens`` and
        ``max_sentences`` times N, batch sizes a multiple of N, each batch
        trimmed to a multiple of N and empty ones dropped
        (``neuralsvb_tpu/tasks/base_task.py:108-130``). Every rank builds the
        same global batches and keeps its rows (``ddp.local_batch``). With
        ``drop_last_batch`` a shuffled loader keeps only the batches of
        ``max_sentences`` (else of the largest size) items."""
        if max_tokens is not None:
            max_tokens *= n_devices
        if max_sentences is not None:
            max_sentences *= n_devices
        indices = dataset.ordered_indices()
        if use_batch_by_size:
            batches = batch_by_size(indices, dataset.num_tokens, max_tokens=max_tokens,
                                    max_sentences=max_sentences,
                                    required_batch_size_multiple=n_devices)
        else:
            ms = max_sentences or 1
            batches = [list(indices[i:i + ms]) for i in range(0, len(indices), ms)]
        if n_devices > 1:
            batches = [b for b in (ddp.trim_batch_to_multiple(b, n_devices)
                                   for b in batches) if b]
        if shuffle and hparams.get("drop_last_batch") and batches:
            # only full batches, or all of them if none is full
            # (neuralsvb_tpu/tasks/base_task.py:130-136)
            full = max_sentences or max(len(b) for b in batches)
            batches = [b for b in batches if len(b) == full] or batches
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
