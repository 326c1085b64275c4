"""Ordered multiprocess map of the binarizer; port of
``neuralsvb_tpu/data/multiprocess.py`` (reference:
utils/multiprocess_utils.py:23-111).

Work fans out to N worker processes and results come back in submission
order; a worker exception yields None for that item (skipped upstream, as
in the reference's crash-tolerant binarize loop, base_binarizer.py:144-145).
Workers are spawned, never forked: CUDA cannot be used in a forked child.
Each worker gets the parent's hparams and opens the device they name.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback


def _hparams_initializer(hp: dict):
    from ..hparams import hparams, resolve_device
    hparams.clear()
    hparams.update(hp)
    resolve_device(hp.get("device"))


def _worker(fn, in_q, out_q, initializer=None, init_arg=None):
    if initializer is not None:
        initializer(init_arg)
    while True:
        job = in_q.get()
        if job is None:
            break
        idx, args = job
        try:
            res = fn(*args)
        except KeyboardInterrupt:
            break
        except Exception:
            traceback.print_exc()
            res = None
        out_q.put((idx, res))


def chunked_multiprocess_run(fn, args_list, num_workers: int):
    """Yield fn(*args) for each args in args_list, in order. With one worker
    (or one item) everything runs in this process."""
    n = len(args_list)
    if num_workers <= 1 or n <= 1:
        for args in args_list:
            try:
                yield fn(*args)
            except Exception:
                traceback.print_exc()
                yield None
        return
    from ..hparams import hparams
    ctx = mp.get_context("spawn")
    in_q = ctx.Queue()
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(fn, in_q, out_q, _hparams_initializer, dict(hparams)),
                         daemon=True)
             for _ in range(min(num_workers, n))]
    for p in procs:
        p.start()
    for i, args in enumerate(args_list):
        in_q.put((i, args))
    for _ in procs:
        in_q.put(None)
    results = {}
    next_idx = 0
    received = 0
    try:
        while received < n:
            try:
                idx, res = out_q.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    raise RuntimeError("every worker exited with items left "
                                       f"({n - received} of {n})")
                continue
            received += 1
            results[idx] = res
            while next_idx in results:
                yield results.pop(next_idx)
                next_idx += 1
    finally:
        for p in procs:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
