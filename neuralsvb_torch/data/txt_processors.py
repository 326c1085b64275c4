"""Text processors: raw text -> (phonemes, normalized text); a copy of
``neuralsvb_tpu/data/txt_processors.py`` (reference: data_gen/tts/txt_processors/{en,zh,zh_g2pM}.py).

The environment carries no g2p_en/g2pM models, so the English processor uses
grapheme fallback when g2p is unavailable and the Chinese processor emits
per-character units; both keep the reference's output contract
(space-separated phones with '|' word boundaries).
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ..utils.text_norm import normalize_en, normalize_zh

REGISTERED_TEXT_PROCESSORS = {}


def register_txt_processors(name):
    def wrap(cls):
        REGISTERED_TEXT_PROCESSORS[name] = cls
        return cls
    return wrap


def get_txt_processor_cls(name):
    return REGISTERED_TEXT_PROCESSORS[name]


class BaseTxtProcessor:
    @classmethod
    def process(cls, txt: str, pre_align_args=None) -> Tuple[List[str], str]:
        raise NotImplementedError


@register_txt_processors("en")
class TxtProcessorEn(BaseTxtProcessor):
    _g2p = None

    @classmethod
    def _get_g2p(cls):
        if cls._g2p is None:
            try:
                from g2p_en import G2p
                g2p = G2p()
                # functional probe: a broken install (missing nltk data
                # raising at first call, or a stubbed module) must fall
                # back to graphemes instead of silently emitting nothing
                probe = [p for p in g2p("hi")
                         if isinstance(p, str) and p.strip()]
                cls._g2p = g2p if probe else False
            except Exception:  # noqa: BLE001 — any failure -> fallback
                cls._g2p = False
        return cls._g2p

    @classmethod
    def process(cls, txt, pre_align_args=None):
        txt = normalize_en(txt)
        g2p = cls._get_g2p()
        phs: List[str] = []
        for word in txt.split(" "):
            if not word:
                continue
            if g2p:
                phs += [p for p in g2p(word) if p.strip()]
            else:
                phs += list(word)  # grapheme fallback
            phs.append("|")
        if phs and phs[-1] == "|":
            phs.pop()
        return phs, txt


@register_txt_processors("zh")
class TxtProcessorZh(BaseTxtProcessor):
    @classmethod
    def process(cls, txt, pre_align_args=None):
        txt = normalize_zh(txt)
        phs: List[str] = []
        for ch in txt:
            if re.match(r"\s", ch):
                continue
            phs.append(ch)
            phs.append("|")
        if phs and phs[-1] == "|":
            phs.pop()
        return phs, txt


# pinyin initial/final inventory (reference: txt_processors/zh_g2pM.py:8-12)
ALL_SHENMU = ['zh', 'ch', 'sh', 'b', 'p', 'm', 'f', 'd', 't', 'n', 'l', 'g',
              'k', 'h', 'j', 'q', 'x', 'r', 'z', 'c', 's', 'y', 'w']
PUNCS = '!,.?;:'


def split_shenmu(p: str) -> List[str]:
    """Split a pinyin syllable into initial + final (reference:
    zh_g2pM.py:50-57); returns [p] when no initial matches."""
    if sum(c.isalpha() for c in p) > 1:
        for shenmu in ALL_SHENMU:
            if p.startswith(shenmu) and not p[len(shenmu):].isnumeric():
                return [shenmu, p[len(shenmu):]]
    return [p]


def zh_g2pm_phoneme_seq(ph_list: List[str], seg_list: str,
                        use_tone: bool = True,
                        pinyin_fn=None) -> List[str]:
    """Pure post-processing core of the zh_g2pM pipeline (reference:
    zh_g2pM.py:23-68): interleave word boundaries from the jieba
    segmentation, re-pinyinize untranscribed hanzi, split initials/finals,
    drop boundary markers adjacent to silence phonemes."""
    assert len(ph_list) == len([s for s in seg_list if s != '#']), \
        (ph_list, seg_list)
    out: List[str] = []
    seg_idx = 0
    for p in ph_list:
        p = p.replace("u:", "v")
        if seg_list[seg_idx] == '#':
            out.append('#')
            seg_idx += 1
        else:
            out.append('|')
        seg_idx += 1
        if re.findall(r'[一-鿿]', p):
            if pinyin_fn is None:
                raise ImportError(
                    "pypinyin is required to transcribe residual hanzi "
                    "(not available in this environment)")
            p = pinyin_fn(p, use_tone)
            if use_tone and p[-1] not in '12345':
                p = p + '5'
        out.extend(split_shenmu(p))
    sil = list(PUNCS) + ['|', '#']
    cleaned: List[str] = []
    for i, p in enumerate(out):
        if p != '#' or (out[i - 1] not in sil and out[i + 1] not in sil):
            cleaned.append(p)
    return cleaned


@register_txt_processors("zh_g2pM")
class TxtProcessorZhG2pM(BaseTxtProcessor):
    """Pinyin phonemization via g2pM + jieba word boundaries (reference:
    data_gen/tts/txt_processors/zh_g2pM.py). The g2pM/jieba/pypinyin
    packages are not in the baked environment; construction of the actual
    model is lazy and raises a clear ImportError when absent."""
    _model = None

    @staticmethod
    def sp_phonemes():
        return ['|', '#']

    @classmethod
    def process(cls, txt, pre_align_args=None):
        pre_align_args = pre_align_args or {"use_tone": True}
        import jieba  # gated deps
        from g2pM import G2pM
        from pypinyin import Style, pinyin as _pinyin
        if cls._model is None:
            cls._model = G2pM()
        txt = normalize_zh(txt)
        ph_list = cls._model(txt, tone=pre_align_args['use_tone'],
                             char_split=True)
        seg_list = '#'.join(jieba.cut(txt))

        def pinyin_fn(p, use_tone):
            style = Style.TONE3 if use_tone else Style.NORMAL
            return _pinyin(p, style=style, strict=True)[0][0]

        return zh_g2pm_phoneme_seq(ph_list, seg_list,
                                   pre_align_args['use_tone'],
                                   pinyin_fn), txt
