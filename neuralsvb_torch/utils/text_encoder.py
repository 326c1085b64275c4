"""Token/id vocabulary encoder; a copy of ``neuralsvb_tpu/utils/text_encoder.py``
(reference: utils/text_encoder.py:157-304).

Reserved ids: 0 = <pad>, 1 = <EOS>, 2 = <UNK>, 3 = | (segment). Initializing
from a list prepends the reserved tokens; from a file they must be included.
"""

from __future__ import annotations

from typing import List, Optional

PAD, EOS, UNK, SEG = "<pad>", "<EOS>", "<UNK>", "|"
RESERVED_TOKENS = [PAD, EOS, UNK, SEG]
PAD_ID, EOS_ID, UNK_ID, SEG_ID = 0, 1, 2, 3

IS_SIL = lambda p: not p or not p[0].isalpha()  # noqa: E731


def is_sil_phoneme(p: str) -> bool:
    return IS_SIL(p)


class TokenTextEncoder:
    def __init__(self, vocab_filename: Optional[str] = None, reverse: bool = False,
                 vocab_list: Optional[List[str]] = None,
                 replace_oov: Optional[str] = None):
        self._reverse = reverse
        self._replace_oov = replace_oov
        if vocab_filename:
            with open(vocab_filename) as f:
                tokens = [line.strip() for line in f if line.strip()]
        else:
            assert vocab_list is not None
            tokens = RESERVED_TOKENS + list(vocab_list)
        self._id_to_token = dict(enumerate(tokens))
        self._token_to_id = {t: i for i, t in self._id_to_token.items()}
        self.pad_index = self._token_to_id.get(PAD, PAD_ID)
        self.eos_index = self._token_to_id.get(EOS, EOS_ID)
        self.unk_index = self._token_to_id.get(UNK, UNK_ID)
        self.seg_index = self._token_to_id.get(SEG, self.eos_index)

    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov
                      for t in tokens]
        ids = [self._token_to_id[t] for t in tokens]
        return ids[::-1] if self._reverse else ids

    def decode(self, ids, strip_eos: bool = False, strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and self.pad() in ids:
            ids = ids[: ids.index(self.pad())]
        if strip_eos and self.eos() in ids:
            ids = ids[: ids.index(self.eos())]
        return " ".join(self.decode_list(ids))

    def decode_list(self, ids) -> List[str]:
        seq = reversed(list(ids)) if self._reverse else ids
        return [self._id_to_token.get(int(i), f"ID_{int(i)}") for i in seq]

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def __len__(self):
        return self.vocab_size

    def pad(self):
        return self.pad_index

    def eos(self):
        return self.eos_index

    def unk(self):
        return self.unk_index

    def seg(self):
        return self.seg_index

    def sil_phonemes(self) -> List[str]:
        return [t for t in self._token_to_id if is_sil_phoneme(t)]

    def store_to_file(self, filename: str):
        with open(filename, "w") as f:
            for i in range(len(self._id_to_token)):
                f.write(self._id_to_token[i] + "\n")


def build_token_encoder(vocab_path_or_list, replace_oov=","):
    if isinstance(vocab_path_or_list, str):
        import json
        with open(vocab_path_or_list) as f:
            vocab_list = json.load(f)
    else:
        vocab_list = vocab_path_or_list
    return TokenTextEncoder(None, vocab_list=vocab_list, replace_oov=replace_oov)
