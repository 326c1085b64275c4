"""MCD parity harness: the mel-cepstral distortion between two directories
of generated mels; port of ``neuralsvb_tpu/tasks/mcd_eval.py`` (the
``BASELINE.md`` parity metric: a2p mels within 0.1 dB).

Usage::

    python -m neuralsvb_torch.tasks.mcd_eval --dir_a <run>/mels/a2p_mel \\
        --dir_b <other run>/mels/a2p_mel

Files are matched by basename; it prints the MCD of each and their mean.
Host numpy only, so it needs no ``device``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..utils.metrics import mel_cepstral_distortion


def evaluate_dirs(dir_a: str, dir_b: str, n_mfcc: int = 13) -> float:
    files_a = {os.path.basename(f): f for f in glob.glob(os.path.join(dir_a, "*.npy"))}
    files_b = {os.path.basename(f): f for f in glob.glob(os.path.join(dir_b, "*.npy"))}
    common = sorted(set(files_a) & set(files_b))
    if not common:
        raise SystemExit(f"no common .npy files between {dir_a} and {dir_b}")
    mcds = []
    for name in common:
        a, b = np.load(files_a[name]), np.load(files_b[name])
        mcd = mel_cepstral_distortion(a, b, n_mfcc)
        mcds.append(mcd)
        print(f"| {name}: MCD {mcd:.4f} dB (T {len(a)} vs {len(b)})")
    mean = float(np.mean(mcds))
    print(f"| mean MCD over {len(common)} items: {mean:.4f} dB")
    return mean


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir_a", required=True)
    ap.add_argument("--dir_b", required=True)
    ap.add_argument("--n_mfcc", type=int, default=13)
    args = ap.parse_args(argv)
    return evaluate_dirs(args.dir_a, args.dir_b, args.n_mfcc)


if __name__ == "__main__":
    main()
