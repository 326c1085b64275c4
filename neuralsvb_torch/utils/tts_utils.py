"""Mask and attention-diagnostic helpers on tensors (port of
``neuralsvb_tpu/utils/tts_utils.py``; reference: utils/tts_utils.py:6-371)."""

from __future__ import annotations

import torch


def sequence_mask(lengths, max_len=None):
    """[B] lengths -> [B, T] boolean mask (True = valid)."""
    lengths = torch.as_tensor(lengths)
    if max_len is None:
        max_len = int(lengths.max())
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def make_pad_mask(lengths, max_len=None):
    """True where padded (ESPnet convention)."""
    return ~sequence_mask(lengths, max_len)


def make_positions(tensor_ids, padding_idx: int = 0):
    """Position numbering that skips padding (fairseq convention)."""
    mask = (tensor_ids != padding_idx).int()
    return torch.cumsum(mask, -1, dtype=torch.int32) * mask + padding_idx


def get_focus_rate(attn, src_padding_mask=None, tgt_padding_mask=None):
    """Mean of per-target-step max attention (diagnostic for enc-dec attn).
    attn: [B, T_tgt, T_src]."""
    attn = torch.as_tensor(attn)
    if src_padding_mask is not None:
        attn = attn * (1 - src_padding_mask.to(attn.dtype))[:, None, :]
    focus = attn.max(-1).values  # [B, T_tgt]
    if tgt_padding_mask is not None:
        keep = 1 - tgt_padding_mask.to(attn.dtype)
        return (focus * keep).sum(-1) / keep.sum(-1).clamp_min(1.0)
    return focus.mean(-1)


def get_phone_coverage_rate(attn, src_padding_mask=None, tgt_padding_mask=None,
                            threshold: float = 0.1):
    """Fraction of source positions that receive > threshold attention from
    some target step."""
    attn = torch.as_tensor(attn)
    if tgt_padding_mask is not None:
        attn = attn * (1 - tgt_padding_mask.to(attn.dtype))[:, :, None]
    covered = (attn.max(1).values > threshold).to(attn.dtype)  # [B, T_src]
    if src_padding_mask is not None:
        keep = 1 - src_padding_mask.to(attn.dtype)
        return (covered * keep).sum(-1) / keep.sum(-1).clamp_min(1.0)
    return covered.mean(-1)
