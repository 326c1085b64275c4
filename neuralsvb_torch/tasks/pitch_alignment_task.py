"""Offline DTW alignment-accuracy harness; port of
``neuralsvb_tpu/tasks/pitch_alignment_task.py`` (reference:
tasks/singing/pitch_alignment_task.py:41-140).

Every aligner named in ``align_funcs`` runs over a packed split. An item's
accuracy is the fraction of frames where the aligned amateur ``mel2ph``
equals the professional ``prof_mel2ph`` (reference: shape_aware_dtw.py:
174-179); an item without both falls back to an f0 proxy, the share of
frames whose aligned amateur f0 and professional f0 agree on voicing.
SADTW and EHSADTW compute their chi-square cost on the ``device`` the
hparams name (one ``chi2_dist`` launch per item on the card); the DP and the
Euclidean aligners run on the host.

Usage::

    python -m neuralsvb_torch.tasks.pitch_alignment_task --config <yaml> \\
        [--hparams "align_funcs=EHSADTW|SADTW,align_split=test,device=cpu"]

Besides the JAX package's lines it prints ``| pitch alignment summary:
{json}`` (seconds, items and chi-square launches per aligner).
"""

from __future__ import annotations

import json
import os
import time
from multiprocessing.pool import ThreadPool

import numpy as np

from ..hparams import hparams, resolve_device, set_hparams
from ..ops import dtw as dtw_ops
from ..ops.chi2 import chi2_dist

THRESHOLD = 0.3


def item_accuracy(item, func_name: str, device=None) -> float:
    f0_a = np.asarray(item["f0"], np.float64)
    f0_p = np.asarray(item["prof_f0"], np.float64)
    fn = dtw_ops.ALIGN_FUNCS[func_name]
    if "mel2ph" in item and "prof_mel2ph" in item:
        aligned, _ = fn(f0_a, f0_p, np.asarray(item["mel2ph"]), device)
        tgt = np.asarray(item["prof_mel2ph"])[: len(aligned)]
        return float((aligned[: len(tgt)] == tgt).mean())
    _, alignment = fn(f0_a, f0_p, f0_a, device)
    aligned_f0 = f0_a[alignment]
    tgt = f0_p[: len(aligned_f0)]
    return float(((aligned_f0 > 0) == (tgt > 0)).mean())


def evaluate(split: str = "test", func_names=("EHSADTW",), n_workers: int = 8, device=None):
    """{aligner: {avg, max, min, n_below_threshold}} over ``split`` of
    ``binary_data_dir``; ``device`` defaults to the ``device`` hparam."""
    from ..data.indexed_dataset import IndexedDataset
    device = resolve_device(device if device is not None else hparams.get("device"))
    ds = IndexedDataset(os.path.join(hparams["binary_data_dir"], split))
    results, summary = {}, {"device": str(device), "split": split, "items": len(ds)}
    pool = ThreadPool(n_workers)
    try:
        for name in func_names:
            t0, launches = time.perf_counter(), chi2_dist.launches
            accs = np.asarray(pool.map(lambda i: item_accuracy(ds[i], name, device),
                                       range(len(ds))))
            results[name] = {"avg": float(accs.mean()), "max": float(accs.max()),
                             "min": float(accs.min()),
                             "n_below_threshold": int((accs < THRESHOLD).sum())}
            summary[name] = {"seconds": time.perf_counter() - t0,
                             "chi2_dist_launches": chi2_dist.launches - launches}
            print(f"| {name} [{split}] avg={results[name]['avg']:.4f} "
                  f"max={results[name]['max']:.4f} min={results[name]['min']:.4f} "
                  f"bad(<{THRESHOLD})={results[name]['n_below_threshold']}")
    finally:
        pool.close()
        pool.join()
    print(f"| pitch alignment summary: {json.dumps(summary)}", flush=True)
    return results


def main():
    set_hparams()
    funcs = hparams.get("align_funcs", "EHSADTW")
    return evaluate(hparams.get("align_split", "test"), tuple(funcs.split("|")))


if __name__ == "__main__":
    main()
