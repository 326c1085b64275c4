"""Text normalization for the text-label pipeline; a copy of
``neuralsvb_tpu/utils/text_norm.py`` (the port imports nothing of the JAX
package; ``tests/test_torch_text.py`` holds the two equal) (reference:
utils/text_norm.py + data_gen/tts/txt_processors/en.py).

English side: number expansion, abbreviation/punctuation cleanup.
Chinese side: a full NSW (non-standard word) normalizer with the same
category coverage and rule ORDER as the reference NSWNormalizer
(utils/text_norm.py:603-717): dates, money, mobile/fixed telephone numbers,
fractions, percentages, quantified cardinals, decimals, long digit strings,
plain cardinals, and the letter-2-letter 'O2O' particular case. The number
reader reproduces the reference's 两/零/一十 conventions (num2chn,
utils/text_norm.py:319-416) — black-box parity-tested against the actual
reference module in tests/test_parity_reference.py."""

from __future__ import annotations

import re
import string

_EN_ABBREV = [(re.compile(rf"\b{k}\.", re.IGNORECASE), v) for k, v in [
    ("mrs", "missis"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("gen", "general"), ("drs", "doctors"),
    ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
    ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
    ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]]

_UNITS = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
          "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
          "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def _num_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _num_to_words(-n)
    if n < 20:
        return _UNITS[n] or "zero"
    if n < 100:
        t, u = divmod(n, 10)
        return _TENS[t] + (f" {_UNITS[u]}" if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return f"{_UNITS[h]} hundred" + (f" {_num_to_words(r)}" if r else "")
    for div, name in [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand")]:
        if n >= div:
            q, r = divmod(n, div)
            return f"{_num_to_words(q)} {name}" + (f" {_num_to_words(r)}" if r else "")
    return str(n)


def expand_numbers_en(text: str) -> str:
    return re.sub(r"\d+", lambda m: _num_to_words(int(m.group())), text)


def normalize_en(text: str) -> str:
    text = text.lower()
    for pat, rep in _EN_ABBREV:
        text = pat.sub(rep, text)
    text = expand_numbers_en(text)
    text = re.sub(r"[\"()\[\]{}<>]", " ", text)
    text = re.sub(r"[;:]", ",", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text


_ZH_DIGITS = "零一二三四五六七八九"
# descending positional units; coefficients recurse into the same table
_ZH_UNITS = [(10 ** 12, "兆"), (10 ** 8, "亿"), (10 ** 4, "万"),
             (1000, "千"), (100, "百"), (10, "十")]


def zh_digits(s: str) -> str:
    """Digit-by-digit reading (phone numbers, years, long IDs)."""
    return "".join(_ZH_DIGITS[int(c)] for c in s if c.isdigit())


def _zh_cardinal_int(n: int) -> str:
    """Positional reading by largest-unit recursion. Conventions (matching
    the reference num2chn defaults): coefficient 2 reads 两 before units
    >= 100; a single 零 marks any skipped unit gap; 一十 keeps its 一 except
    at the very start of the full reading (handled by the caller)."""
    if n < 10:
        return _ZH_DIGITS[n]
    for u, name in _ZH_UNITS:
        if n >= u:
            q, r = divmod(n, u)
            q_read = "两" if (q == 2 and u >= 100) else _zh_cardinal_int(q)
            out = q_read + name
            if r:
                if r < u // 10:
                    out += "零"
                out += _zh_cardinal_int(r)
            return out
    return _ZH_DIGITS[n]  # unreachable


def zh_cardinal(num: str) -> str:
    """'12345.60' -> 一万两千三百四十五点六零 (integer part positional,
    fractional digits digit-wise)."""
    num = num.lstrip("+")
    neg = num.startswith("-")
    num = num.lstrip("-")
    int_part, _, frac = num.partition(".")
    out = _zh_cardinal_int(int(int_part or "0"))
    if out.startswith("一十"):
        out = out[1:]
    if frac:
        out += "点" + zh_digits(frac)
    return ("负" if neg else "") + out


_CURRENCY = r"(?:人民币)?(?:美|港|新|台|澳)?(?:元|块钱?|角|毛)"
# common measure words (incl. 万/亿/兆 acting as magnitude quantifiers)
_QUANTIFIERS = ("万亿兆个只条张座回场尾首阵辆颗棵支枝件名位身本页家户层丝毫厘碗碟箱笼"
                "盏锅篮盘桶罐瓶壶杯粒幢堆根道面片块元角毛米克吨斤两年月日号秒周天季度"
                "小时分钟公里千米厘米毫米平方立方升毫升倍番次回趟遍股套组批对双打队")


class NSWNormalizer:
    """Chinese non-standard-word normalizer (reference:
    utils/text_norm.py:603-717 — same categories, same application order)."""

    def __init__(self, raw_text: str):
        self.raw_text = "^" + raw_text + "$"

    @staticmethod
    def _date(m: re.Match) -> str:
        s = m.group(0)
        s = re.sub(r"(\d{2,4})年", lambda x: zh_digits(x.group(1)) + "年", s)
        s = re.sub(r"(\d{1,2})月", lambda x: zh_cardinal(x.group(1)) + "月", s)
        s = re.sub(r"(\d{1,2})([日号])",
                   lambda x: zh_cardinal(x.group(1)) + x.group(2), s)
        return s

    @staticmethod
    def _numbers_to_cardinal(s: str) -> str:
        return re.sub(r"\d+(\.\d+)?", lambda x: zh_cardinal(x.group(0)), s)

    @staticmethod
    def _telephone(s: str) -> str:
        s = s.replace("+86", "86").replace(" ", "").replace("-", "")
        return zh_digits(s)

    def normalize(self, remove_punc: bool = True) -> str:
        text = self.raw_text
        # dates: [YY]YY年 M月 [D日/号] (reference: text_norm.py:623-629)
        text = re.sub(
            r"((?:(?:[089]\d|(?:19|20)\d{2})年)?(?:\d{1,2}月(?:\d{1,2}[日号])?)|"
            r"(?:[089]\d|(?:19|20)\d{2})年)",
            self._date, text)
        # money: number + currency unit (+ optional sub-unit number)
        text = re.sub(r"(\d+(?:\.\d+)?)([多余几]?" + _CURRENCY + r")(\d)?",
                      lambda m: zh_cardinal(m.group(1)) + m.group(2)
                      + (zh_cardinal(m.group(3)) if m.group(3) else ""), text)
        # mobile numbers (with optional +86), then fixed-line numbers
        text = re.sub(r"(?<=\D)(\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8}(?=\D)",
                      lambda m: self._telephone(m.group(0)), text)
        text = re.sub(r"(?<=\D)(0(10|2[0-9]|[3-9]\d{2})-?)?[1-9]\d{6,7}(?=\D)",
                      lambda m: self._telephone(m.group(0)), text)
        # fractions: a/b -> b分之a
        text = re.sub(r"(\d+)/(\d+)",
                      lambda m: zh_cardinal(m.group(2)) + "分之"
                      + zh_cardinal(m.group(1)), text)
        # percentages
        text = text.replace("％", "%")
        text = re.sub(r"(\d+(?:\.\d+)?)%",
                      lambda m: "百分之" + zh_cardinal(m.group(1)), text)
        # quantified cardinals: number + (多/余/几) + measure word
        text = re.sub(r"(\d+(?:\.\d+)?)(?=[多余几]?[" + _QUANTIFIERS + r"])",
                      lambda m: zh_cardinal(m.group(1)), text)
        # decimals
        text = re.sub(r"\d+\.\d+", lambda m: zh_cardinal(m.group(0)), text)
        # long digit strings (IDs, years): digit-wise
        text = re.sub(r"\d{4,32}", lambda m: zh_digits(m.group(0)), text)
        # remaining cardinals
        text = re.sub(r"\d+", lambda m: zh_cardinal(m.group(0)), text)
        # 'O2O'/'B2C' particular: letters二letters -> letters2letters
        text = re.sub(r"([a-zA-Z]+)二([a-zA-Z]+)", r"\g<1>2\g<2>", text)
        text = text.lstrip("^").rstrip("$")
        if remove_punc:
            from_chars = ("！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀"
                          "｛｜｝～｟｠｢｣､、〃《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞"
                          "〟〰〾〿–—‘’‛“”„‟…‧﹏" + string.punctuation)
            text = text.translate(str.maketrans(from_chars,
                                                " " * len(from_chars)))
        return text


def normalize_zh(text: str) -> str:
    text = NSWNormalizer(text).normalize(remove_punc=False)
    text = re.sub(r"[，、]", ",", text)
    text = re.sub(r"[。！？]", ".", text)
    return text.strip()


class NormalizeText:
    """Dispatch by language (reference: txt_processors registry)."""

    @staticmethod
    def __call__(text: str, lang: str = "en") -> str:
        return normalize_en(text) if lang == "en" else normalize_zh(text)
