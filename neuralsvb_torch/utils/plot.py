"""Validation figures: mel heatmaps, f0 overlays, duration plots (port of
``neuralsvb_tpu/utils/plot.py``; reference: utils/plot.py:11-64).

``matplotlib`` is imported when a figure is drawn, not with the module:
``JsonLogger.writes_figures`` says whether it is installed, and the tasks
draw only then. The JAX package's ``tb_add_audio`` is the logger's
``add_audio`` here."""

from __future__ import annotations

import numpy as np

LINE_COLORS = ["w", "r", "y", "cyan", "m", "b", "lime"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    """A tensor on any device or an array -> numpy (bf16 / fp16 as float32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def spec_to_figure(spec, vmin=None, vmax=None, title=""):
    plt = _plt()
    spec = _np(spec)
    fig = plt.figure(figsize=(12, 6))
    plt.title(title)
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    return fig


def spec_f0_to_figure(spec, f0s, figsize=None):
    plt = _plt()
    spec = _np(spec)
    max_y = spec.shape[1]
    f0s = {k: _np(v) / 10 for k, v in f0s.items()}
    fig = plt.figure(figsize=(12, 6) if figsize is None else figsize)
    plt.pcolor(spec.T)
    for i, (k, f0) in enumerate(f0s.items()):
        plt.plot(f0.clip(0, max_y), label=k, c=LINE_COLORS[i % len(LINE_COLORS)],
                 linewidth=1, alpha=0.8)
    plt.legend()
    return fig


def f0_to_figure(f0_gt, f0_cwt=None, f0_pred=None):
    plt = _plt()
    fig = plt.figure(figsize=(12, 8))
    plt.plot(_np(f0_gt), color="r", label="gt")
    if f0_cwt is not None:
        plt.plot(_np(f0_cwt), color="b", label="cwt")
    if f0_pred is not None:
        plt.plot(_np(f0_pred), color="green", label="pred")
    plt.legend()
    return fig


def dur_to_figure(dur_gt, dur_pred, txt):
    plt = _plt()
    dur_gt = np.cumsum(_np(dur_gt)).astype(int)
    dur_pred = np.cumsum(_np(dur_pred)).astype(int)
    fig = plt.figure(figsize=(12, 6))
    for i in range(len(dur_gt)):
        shift = (i % 8) + 1
        plt.text(dur_gt[i], shift * 4, txt[i])
        plt.text(dur_pred[i], 40 + shift * 4, txt[i])
        plt.vlines(dur_gt[i], 0, 40, colors="b")
        plt.vlines(dur_pred[i], 40, 80, colors="r")
    plt.xlim(0, max(dur_gt[-1], dur_pred[-1]))
    return fig
