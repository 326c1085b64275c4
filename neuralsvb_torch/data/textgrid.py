"""Praat TextGrid parsing + phone-level alignment to frames; a copy of
``neuralsvb_tpu/data/textgrid.py``.

Re-implements the reference's MFA-alignment ingestion
(reference: data_gen/tts/data_gen_utils.py:197-337): parse IntervalTier
TextGrids, merge silence intervals, map phone boundaries to mel frames ->
``mel2ph`` (frame i belongs to phone mel2ph[i], 1-indexed; 0 = padding).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from ..utils.text_encoder import is_sil_phoneme

SIL_LABELS = {"sil", "sp", "", "SIL", "PUNC"}


def parse_textgrid(text: str) -> List[Dict]:
    """Parse a (long-format) TextGrid; returns the tier list, each tier a dict
    with 'name' and 'items' [{xmin, xmax, text}]."""
    lines = [l.strip() for l in text.splitlines() if l.strip()]
    tiers = []
    i = 0
    cur = None
    items = None
    while i < len(lines):
        line = lines[i]
        m = re.match(r'name = "(.*)"', line)
        if m and cur is None or (m and items is not None):
            if cur is not None:
                tiers.append(cur)
            cur = {"name": m.group(1), "items": []}
            items = cur["items"]
        m = re.match(r"intervals \[\d+\]", line)
        if m and cur is not None:
            xmin = float(re.match(r"xmin = (.*)", lines[i + 1]).group(1))
            xmax = float(re.match(r"xmax = (.*)", lines[i + 2]).group(1))
            txt = re.match(r'text = "(.*)"', lines[i + 3]).group(1)
            items.append({"xmin": xmin, "xmax": xmax, "text": txt})
            i += 3
        i += 1
    if cur is not None:
        tiers.append(cur)
    return tiers


def _merge_sil(items: List[Dict]) -> List[Dict]:
    merged = []
    for x in items:
        x = dict(x)
        if x["text"] in SIL_LABELS:
            x["text"] = ""
            if merged and merged[-1]["text"] == "":
                merged[-1]["xmax"] = x["xmax"]
                continue
        merged.append(x)
    return merged


def get_mel2ph(tg_fn: str, ph: str, mel: np.ndarray, hp: dict):
    """TextGrid + phone string -> (mel2ph [T_mel], dur [T_ph])
    (reference: data_gen_utils.py:276-337)."""
    ph_list = ph.split(" ")
    with open(tg_fn) as f:
        tiers = parse_textgrid(f.read())
    tg_align = _merge_sil(tiers[-1]["items"])
    tg_len = len([x for x in tg_align if x["text"] != ""])
    ph_len = len([p for p in ph_list if not is_sil_phoneme(p)])
    assert tg_len == ph_len, (tg_len, ph_len, tg_fn)

    split = np.full(len(ph_list) + 1, -1.0)
    tg_idx = ph_idx = 0
    while tg_idx < len(tg_align) or ph_idx < len(ph_list):
        if tg_idx == len(tg_align) and is_sil_phoneme(ph_list[ph_idx]):
            split[ph_idx] = 1e8
            ph_idx += 1
            continue
        x = tg_align[tg_idx]
        if x["text"] == "" and ph_idx == len(ph_list):
            tg_idx += 1
            continue
        p = ph_list[ph_idx]
        if x["text"] == "" and not is_sil_phoneme(p):
            raise AssertionError((ph_list, tg_align))
        if x["text"] != "" and is_sil_phoneme(p):
            ph_idx += 1
        else:
            split[ph_idx] = x["xmin"]
            if ph_idx > 0 and split[ph_idx - 1] == -1 \
                    and is_sil_phoneme(ph_list[ph_idx - 1]):
                split[ph_idx - 1] = split[ph_idx]
            ph_idx += 1
            tg_idx += 1
    split[0] = 0
    split[-1] = 1e8
    frames = [int(s * hp["audio_sample_rate"] / hp["hop_size"] + 0.5)
              for s in split]
    mel2ph = np.zeros(mel.shape[0], np.int64)
    for i in range(len(ph_list)):
        mel2ph[frames[i]:frames[i + 1]] = i + 1
    dur = np.bincount(mel2ph, minlength=len(ph_list) + 1)[1:]
    return mel2ph, dur
