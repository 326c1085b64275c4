"""Binarizers: raw paired singing wavs -> packed IndexedDataset with mels,
f0, the EHSADTW alignment and speaker embeddings; port of the PopBuTFy path
of ``neuralsvb_tpu/data/binarizer.py`` (reference:
data_gen/tts/base_binarizer.py:26-165, data_gen/singing/binarize.py:19-58,
data_gen/singing/binarize_para.py:25-260).

- ``BaseBinarizer``: glob ``{processed_data_dir}/data/*/*.{mp3,wav}``,
  speaker from ``item_name.split('#')[0] + '#'``, per-split
  IndexedDatasetBuilder, multiprocess ``process_item`` fan-out. When a
  ``text_labels/`` mirror of ``data/`` holds one .txt per utterance, the
  text branch runs: phones from the language's txt_processor and
  ``phone_set.json`` (``with_txt``), frames aligned from
  ``mfa_outputs/*.TextGrid`` (``with_align``, reference:
  base_binarizer.py:185-216) and word packing with ``word_set.json``
  (``with_word``, reference: base_binarizer.py:255-298).
- ``SingingBinarizer``: dataset-regex filter + ``test_prefixes`` split.
- ``SaveSpkEmb``: pass 1, one GE2E embedding per utterance as .npy.
- ``PopBuTFyENBinarizer``: pairs ``*_Amateur_N`` with ``*_Professional_N``,
  rejects pairs with mel gap > ``max_mel_tech_gap``, extracts both f0s and
  the EHSADTW ``a2p_f0_alignment``.
- ``PopBuTFyENSpkEMBinarizer``: pass 2, + ``multi_spk_emb`` = own +
  ``spk_emb_num`` random same-song embeddings from ``spk_emb_data_dir``.

Mel, pitch candidates, the chi-square DTW cost and GE2E run on the
``device`` the hparams name (required); the DTW and Viterbi dynamic
programs run in the host C++ kernel; the text branch runs on the host.
``with_f0cwt`` adds the Mexican-hat CWT of the continuous log-f0 (host
numpy, ``ops/cwt.py``; with a ``prof_`` prefix for the paired side).
``ZhBinarizer`` and ``SingingPreAlign`` are the placeholders that the
recipes' bases name, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import random
import re
import time
import traceback
from collections import Counter
from copy import deepcopy

import numpy as np
import torch

from ..hparams import hparams, resolve_device
from ..models.ge2e import SpeakerEncoder
from ..ops import dtw as dtw_ops
from ..ops.chi2 import chi2_dist
from ..ops.cwt import get_cont_lf0, get_lf0_cwt
from ..ops.pitch import get_pitch
from ..utils.text_encoder import TokenTextEncoder, build_token_encoder, is_sil_phoneme
from ..vocoders import get_vocoder_cls
from .indexed_dataset import IndexedDatasetBuilder
from .multiprocess import chunked_multiprocess_run
from .textgrid import get_mel2ph
from .txt_processors import get_txt_processor_cls


class BinarizationError(Exception):
    pass


# Per-stage wall seconds of the process's own work, as in the JAX package.
# Every stage ends in a copy to the host, so the host clock times the device
# work too.
STAGE_TIMES: dict = {}


@contextlib.contextmanager
def _stage(name, times=STAGE_TIMES):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def _with_stats(fn, *args):
    """``fn(*args)`` plus the stage seconds and chi-square kernel launches
    it took, so a worker process reports its share to the parent."""
    before, launches = dict(STAGE_TIMES), chi2_dist.launches
    res = fn(*args)
    return res, {k: v - before.get(k, 0.0) for k, v in STAGE_TIMES.items()}, \
        chi2_dist.launches - launches


def _wav2spec(wav_fn):
    with _stage("stft_mel"):
        return get_vocoder_cls(hparams).wav2spec(wav_fn)


def split_train_test_set(item_names):
    item_names = deepcopy(item_names)
    test = [x for x in item_names
            if any(ts in x for ts in hparams["test_prefixes"])]
    train = [x for x in item_names if x not in set(test)]
    print(f"| train {len(train)}, test {len(test)}")
    return train, test


class BaseBinarizer:
    def __init__(self, processed_data_dir=None):
        if processed_data_dir is None:
            processed_data_dir = hparams["processed_data_dir"]
        self.processed_data_dirs = processed_data_dir.split(",")
        self.binarization_args = hparams["binarization_args"]
        self.device = resolve_device(hparams.get("device"))
        self.item2wavfn = {}
        self.item2spk = {}
        self.item2txt = {}
        self.item2ph = {}
        self.item2tgfn = {}
        self.phone_encoder = self.word_encoder = None
        self.num_workers = int(hparams.get("ds_workers", 1)) or 1
        self.items_per_split = {}
        self.stage_seconds = {}
        self.chi2_launches = 0

    def load_meta_data(self):
        for ds_id, processed_data_dir in enumerate(self.processed_data_dirs):
            wav_fns = sorted(glob.glob(f"{processed_data_dir}/data/*/*.mp3")
                             + glob.glob(f"{processed_data_dir}/data/*/*.wav"))
            for wav_fn in wav_fns:
                raw_name = os.path.splitext(os.path.basename(wav_fn))[0]
                item_name = raw_name
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                self.item2wavfn[item_name] = wav_fn
                spk = item_name.split("#")[0] + "#"
                if len(self.processed_data_dirs) > 1:
                    spk = f"ds{ds_id}_{spk}"
                self.item2spk[item_name] = spk
                self._load_text_labels(processed_data_dir, wav_fn, raw_name, item_name)
        self.item_names = sorted(self.item2wavfn.keys())
        print("| Total items:", len(self.item_names))
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)

    def _load_text_labels(self, processed_data_dir, wav_fn, raw_name, item_name):
        """The text branch's inputs of one utterance: its transcript in the
        ``text_labels/`` mirror of ``data/`` (phones through the language's
        txt_processor, framed by ``<BOS>``/``<EOS>``) and its MFA TextGrid
        under ``mfa_outputs/`` (reference: base_binarizer.py:43)."""
        txt_fn = os.path.splitext(wav_fn.replace(f"{os.sep}data{os.sep}",
                                                 f"{os.sep}text_labels{os.sep}"))[0] + ".txt"
        if os.path.exists(txt_fn):
            with open(txt_fn) as f:
                txt = f.read().strip()
            self.item2txt[item_name] = txt
            pre_align_args = hparams.get("pre_align_args", {})
            phs, _ = get_txt_processor_cls(pre_align_args.get("txt_processor", "en")).process(
                txt, pre_align_args)
            self.item2ph[item_name] = " ".join(
                ["<BOS>"] + [p for p in phs if p.strip()] + ["<EOS>"])
        tg_fn = f"{processed_data_dir}/mfa_outputs/{raw_name}.TextGrid"
        if os.path.exists(tg_fn):
            self.item2tgfn[item_name] = tg_fn

    def _phone_encoder(self):
        """Build (or read) ``phone_set.json``: the sorted phones of every
        transcript (reference: data_gen_utils.py build_phone_encoder)."""
        fn = f"{hparams['binary_data_dir']}/phone_set.json"
        if self.binarization_args.get("reset_phone_dict") or not os.path.exists(fn):
            phones = sorted({p for ph in self.item2ph.values()
                             for p in ph.split(" ") if p.strip()})
            with open(fn, "w") as f:
                json.dump(phones, f)
            print(f"| Build phone set. Size: {len(phones)}")
        return build_token_encoder(fn)

    def _word_encoder(self):
        """Build (or read) ``word_set.json``: the ``word_size`` most common
        words (reference: base_binarizer.py:88-104)."""
        fn = f"{hparams['binary_data_dir']}/word_set.json"
        if self.binarization_args.get("reset_word_dict") or not os.path.exists(fn):
            counts = Counter(w for txt in self.item2txt.values()
                             for w in txt.split(" ") if w)
            word_set = [w for w, _ in counts.most_common(hparams.get("word_size", 30000))]
            with open(fn, "w") as f:
                json.dump(word_set, f)
            print(f"| Build word set. Size: {len(word_set)}")
        else:
            with open(fn) as f:
                word_set = json.load(f)
        return TokenTextEncoder(None, vocab_list=word_set, replace_oov="<UNK>")

    @property
    def train_item_names(self):
        return self.item_names[hparams["test_num"]:]

    @property
    def valid_item_names(self):
        return self.item_names[: hparams["test_num"]]

    @property
    def test_item_names(self):
        return self.valid_item_names

    def build_spk_map(self):
        spk_map = sorted({self.item2spk[i] for i in self.item_names})
        spk_map = {x: i for i, x in enumerate(spk_map)}
        if len(spk_map) > hparams["num_spk"]:
            raise ValueError(f"{len(spk_map)} speakers > num_spk {hparams['num_spk']}")
        return spk_map

    def item_name2spk_id(self, item_name):
        return self.spk_map[self.item2spk[item_name]]

    def meta_data(self, prefix):
        names = {"valid": self.valid_item_names, "test": self.test_item_names}.get(
            prefix, self.train_item_names)
        for item_name in names:
            yield item_name, self.item2wavfn[item_name], self.item_name2spk_id(item_name)

    def process(self):
        self.load_meta_data()
        os.makedirs(hparams["binary_data_dir"], exist_ok=True)
        self.spk_map = self.build_spk_map()
        print("| spk_map:", self.spk_map)
        with open(f"{hparams['binary_data_dir']}/spk_map.json", "w") as f:
            json.dump(self.spk_map, f)
        if self.binarization_args.get("with_txt") and self.item2ph:
            self.phone_encoder = self._phone_encoder()
            if self.binarization_args.get("with_word"):
                self.word_encoder = self._word_encoder()
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)
        self.print_summary()

    def _speaker_encoder(self):
        ckpt = hparams.get("ge2e_ckpt", "")
        return SpeakerEncoder(ckpt if ckpt and os.path.exists(ckpt) else None,
                              self.device)

    def _embed(self, voice_encoder, wav):
        with _stage("ge2e", self.stage_seconds):
            return voice_encoder.embed_utterance(wav, sr=hparams["audio_sample_rate"])

    def _run_items(self, prefix, args):
        """process_item over ``args`` (in worker processes when
        ``ds_workers`` > 1); yields the items that were not skipped."""
        n = 0
        fn = functools.partial(_with_stats, self.process_item)
        for out in chunked_multiprocess_run(fn, args, num_workers=self.num_workers):
            if out is None:
                continue
            item, seconds, launches = out
            for k, v in seconds.items():
                self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v
            self.chi2_launches += launches
            if item is not None:
                n += 1
                yield item
        self.items_per_split[prefix] = n

    def process_data(self, prefix):
        data_dir = hparams["binary_data_dir"]
        builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
        mel_lengths, ph_lengths, f0s = [], [], []
        total_sec = 0.0
        voice_encoder = self._speaker_encoder() \
            if self.binarization_args.get("with_spk_embed") else None
        args = [list(m) + self._text_extras(m[0]) + [self.binarization_args]
                for m in self.meta_data(prefix)]
        for item in self._run_items(prefix, args):
            if voice_encoder is not None:
                item["spk_embed"] = self._embed(voice_encoder, item["wav"])
            if not self.binarization_args.get("with_wav") and "wav" in item:
                del item["wav"]
                item.pop("prof_wav", None)
            builder.add_item(item)
            mel_lengths.append(max(item["len"], item.get("prof_len", 0)))
            if "ph_len" in item:
                ph_lengths.append(item["ph_len"])
            total_sec += item["sec"]
            if item.get("f0") is not None:
                f0s.append(item["f0"])
                if "prof_f0" in item:
                    f0s.append(item["prof_f0"])
        builder.finalize()
        np.save(f"{data_dir}/{prefix}_lengths.npy", mel_lengths)
        if ph_lengths:
            np.save(f"{data_dir}/{prefix}_ph_lengths.npy", ph_lengths)
        if f0s:
            f0s = np.concatenate(f0s, 0)
            f0s = f0s[f0s != 0]
            np.save(f"{data_dir}/{prefix}_f0s_mean_std.npy",
                    [float(np.mean(f0s)), float(np.std(f0s))])
        print(f"| {prefix} total duration: {total_sec:.3f}s")

    def print_summary(self):
        """One ``| binarize summary: {json}`` line: items per split, seconds
        per stage, chi-square kernel launches and the card's peak memory."""
        cuda = self.device.type == "cuda"
        print("| binarize summary: " + json.dumps({
            "device": str(self.device),
            "items": self.items_per_split,
            "stage_seconds": self.stage_seconds,
            "chi2_dist_launches": self.chi2_launches,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(self.device)
                                     if cuda else None)}), flush=True)

    def _text_extras(self, item_name):
        """The text branch's part of one item's ``process_item`` arguments:
        (phones, transcript, TextGrid, (phone encoder, word encoder)), or
        nothing when the branch is off."""
        if not (self.binarization_args.get("with_txt") and self.phone_encoder is not None):
            return []
        return [self.item2ph.get(item_name), self.item2txt.get(item_name),
                self.item2tgfn.get(item_name), (self.phone_encoder, self.word_encoder)]

    @classmethod
    def process_item(cls, item_name, wav_fn, spk_id, *rest):
        binarization_args = rest[-1]
        res = {"item_name": item_name, "wav_fn": wav_fn, "spk_id": spk_id}
        wav, mel = _wav2spec(wav_fn)
        res.update({"mel": mel, "wav": wav,
                    "sec": len(wav) / hparams["audio_sample_rate"],
                    "len": mel.shape[0]})
        try:
            if binarization_args.get("with_f0"):
                cls.get_pitch(res)
                if binarization_args.get("with_f0cwt"):
                    cls.get_f0cwt(res)
            if len(rest) > 1:
                ph, txt, tg_fn, (ph_enc, word_enc) = rest[:-1]
                if ph is None:
                    raise BinarizationError("Empty phoneme")
                res.update({"txt": txt, "ph": ph, "phone": np.asarray(ph_enc.encode(ph))})
                res["ph_len"] = len(res["phone"])
                if binarization_args.get("with_align"):
                    cls.get_align(tg_fn, res)
                    if binarization_args.get("trim_eos_bos"):
                        cls.trim_eos_bos(res)
                if binarization_args.get("with_word") and word_enc is not None:
                    cls.get_word(res, word_enc)
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        except Exception:
            traceback.print_exc()
            print(f"| Skip item. item_name: {item_name}, wav_fn: {wav_fn}")
            return None
        return res

    @staticmethod
    def get_align(tg_fn, res):
        """TextGrid -> ``mel2ph``/``dur`` (reference: base_binarizer.py:216-229)."""
        if tg_fn is None or not os.path.exists(tg_fn):
            raise BinarizationError("Align not found")
        mel2ph, dur = get_mel2ph(tg_fn, res["ph"], res["mel"], hparams)
        if mel2ph.max() - 1 >= len(res["phone"]):
            raise BinarizationError(f"Align mismatch: mel2ph.max()={mel2ph.max()} "
                                    f"vs {len(res['phone'])} phones")
        res["mel2ph"] = mel2ph
        res["dur"] = dur

    @staticmethod
    def trim_eos_bos(res):
        """Drop the aligned ``<BOS>``/``<EOS>`` frames from the mel-rate
        arrays (reference: base_binarizer.py:195-204)."""
        bos_dur, eos_dur = int(res["dur"][0]), int(res["dur"][-1])
        if eos_dur <= 0:
            return
        hop = hparams["hop_size"]
        for k in ("mel", "f0", "pitch", "mel2ph"):
            if k in res:
                res[k] = res[k][bos_dur:-eos_dur]
        res["wav"] = res["wav"][bos_dur * hop: -eos_dur * hop]
        res["dur"] = res["dur"][1:-1]
        res["len"] = res["mel"].shape[0]

    @staticmethod
    def get_word(res, word_encoder):
        """Phone -> word packing: ``ph_words``, ``ph2word``, ``mel2word``,
        ``dur_word``, ``words``, ``word_tokens`` (reference:
        base_binarizer.py:255-298). Word boundaries are the txt_processor's
        '|' separators and punctuation."""
        ph_split = res["ph"].split(" ")
        last_idx = []
        for i, p in enumerate(ph_split):
            if p == "|":
                last_idx.append(i)
            elif not p[0].isalnum():
                if p != "<BOS>" and (not last_idx or last_idx[-1] != i - 1):
                    last_idx.append(i - 1)
                last_idx.append(i)
        if not last_idx or last_idx[-1] != len(ph_split) - 1:
            last_idx.append(len(ph_split) - 1)
        start_idx = [0] + [i + 1 for i in last_idx[:-1]]
        ph2word = np.zeros(len(ph_split), np.int64)
        ph_words = []
        for w, (s, e) in enumerate(zip(start_idx, last_idx)):
            ph_words.append("_".join(ph_split[s:e + 1]))
            ph2word[s:e + 1] = w
        mel2word = [int(ph2word[m - 1]) + 1 for m in res.get("mel2ph", [])]
        dur_word = (np.bincount(np.asarray(mel2word, np.int64),
                                minlength=len(ph_words) + 1)[1:].tolist()
                    if mel2word else [0] * len(ph_words))
        res["ph_words"] = ph_words
        res["ph2word"] = (ph2word + 1).tolist()
        res["mel2word"] = mel2word
        res["dur_word"] = dur_word
        words = [w for w in res.get("txt", "").split(" ") if w]
        while words and is_sil_phoneme(words[0]):
            words = words[1:]
        while words and is_sil_phoneme(words[-1]):
            words = words[:-1]
        words = ["<BOS>"] + words + ["<EOS>"]
        res["words"] = words
        res["word_tokens"] = word_encoder.encode(" ".join(words))

    @staticmethod
    def get_pitch(res, prefix=""):
        wav, mel = res[f"{prefix}wav"], res[f"{prefix}mel"]
        with _stage("pitch"):
            f0, pitch_coarse = get_pitch(wav, mel, hparams,
                                         resolve_device(hparams.get("device")))
        if np.sum(f0) == 0:
            raise BinarizationError("Empty f0")
        res[f"{prefix}f0"] = f0
        res[f"{prefix}pitch"] = pitch_coarse

    @staticmethod
    def get_f0cwt(res, prefix=""):
        """Mexican-hat CWT of the standardized continuous log-f0, with the
        utterance's mean and std (reference: base_binarizer.py:240-252)."""
        with _stage("f0cwt"):
            _uv, cont_lf0 = get_cont_lf0(res[f"{prefix}f0"])
            mean, std = np.mean(cont_lf0), np.std(cont_lf0)
            cwt_spec, scales = get_lf0_cwt((cont_lf0 - mean) / std)
        res[f"{prefix}cwt_spec"] = cwt_spec
        res[f"{prefix}cwt_scales"] = scales
        res[f"{prefix}f0_mean"] = float(mean)
        res[f"{prefix}f0_std"] = float(std)


class SingingBinarizer(BaseBinarizer):
    def load_meta_data(self):
        super().load_meta_data()
        new_item_names = []
        for item_name in self.item_names:
            if any(re.findall(rf"{dataset}", item_name)
                   for dataset in hparams["datasets"]):
                new_item_names.append(item_name)
        self.item_names = new_item_names
        self._train_item_names, self._test_item_names = \
            split_train_test_set(self.item_names)

    @property
    def train_item_names(self):
        return self._train_item_names

    @property
    def valid_item_names(self):
        return self._test_item_names

    @property
    def test_item_names(self):
        return self._test_item_names


class SaveSpkEmb(SingingBinarizer):
    """Pass 1: write per-utterance GE2E embeddings to spk_emb_data_dir
    (reference: binarize_para.py:25-69)."""

    def load_meta_data(self):
        super().load_meta_data()
        self.item_names = [x for x in self.item_names if "#singing#" in x]
        self._train_item_names, self._test_item_names = \
            split_train_test_set(self.item_names)

    def process(self):
        self.load_meta_data()
        self.spk_map = self.build_spk_map()
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)
        self.print_summary()

    def process_data(self, prefix):
        spk_emb_dir = hparams["spk_emb_data_dir"]
        os.makedirs(spk_emb_dir, exist_ok=True)
        voice_encoder = self._speaker_encoder()
        args = [list(m) + [self.binarization_args] for m in self.meta_data(prefix)]
        for item in self._run_items(prefix, args):
            emb = self._embed(voice_encoder, item["wav"])
            np.save(os.path.join(spk_emb_dir, item["item_name"] + ".npy"), emb)

    @classmethod
    def process_item(cls, item_name, wav_fn, spk_id, binarization_args):
        res = {"item_name": item_name, "wav_fn": wav_fn, "spk_id": spk_id}
        wav, mel = _wav2spec(wav_fn)
        res.update({"mel": mel, "wav": wav,
                    "sec": len(wav) / hparams["audio_sample_rate"],
                    "len": mel.shape[0]})
        return res


class PopBuTFyENBinarizer(SingingBinarizer):
    """Paired amateur/professional binarizer (reference: binarize_para.py:72-216)."""

    def load_meta_data(self):
        BaseBinarizer.load_meta_data(self)
        if self.item2ph:
            # the JAX package's paired process_item takes no text arguments
            # and fails on them; the reference pairs have no transcripts
            raise NotImplementedError("the paired binarizer has no text branch: "
                                      "remove text_labels/ or use BaseBinarizer")
        self.amateur2profwavfn = {}
        new_item_names = []
        unpaired = 0
        for item_name in self.item_names:
            if "#singing#" not in item_name or "Professional" in item_name:
                continue
            if not any(re.findall(rf"{dataset}", item_name)
                       for dataset in hparams["datasets"]):
                continue
            prof_fn = self.item2wavfn.get(item_name.replace("Amateur", "Professional"))
            if prof_fn is not None and os.path.exists(prof_fn):
                self.amateur2profwavfn[item_name] = prof_fn
                new_item_names.append(item_name)
            else:
                unpaired += 1
        print(f"| Paired items: {len(new_item_names)}, unpaired: {unpaired}")
        self.item_names = new_item_names
        self._train_item_names, self._test_item_names = \
            split_train_test_set(self.item_names)

    def meta_data(self, prefix):
        names = {"valid": self.valid_item_names, "test": self.test_item_names}.get(
            prefix, self.train_item_names)
        for item_name in names:
            yield (item_name, self.item2wavfn[item_name],
                   self.item_name2spk_id(item_name),
                   self.amateur2profwavfn[item_name])

    @staticmethod
    def get_pitch_align(res, amateur_f0, prof_f0, choosed_func="EHSADTW"):
        fn = dtw_ops.ALIGN_FUNCS[choosed_func]
        with _stage("dtw_align"):
            _aligned, alignment = fn(amateur_f0, prof_f0, amateur_f0,
                                     resolve_device(hparams.get("device")))
        res["a2p_f0_alignment"] = np.asarray(alignment)

    @classmethod
    def process_item(cls, item_name, wav_fn, spk_id, profwavfn, binarization_args):
        res = {"item_name": item_name, "wav_fn": wav_fn, "spk_id": spk_id,
               "a2profwavfn": profwavfn}
        wav, mel = _wav2spec(wav_fn)
        prof_wav, prof_mel = _wav2spec(profwavfn)
        gap = hparams.get("max_mel_tech_gap")
        if gap is not None and abs(mel.shape[0] - prof_mel.shape[0]) > gap:
            with open(hparams["binary_data_dir"] + "/bad_case.txt", "a+") as wf:
                wf.write(f"Gap is too large: {item_name} {mel.shape} {prof_mel.shape}\n")
            return None
        res.update({"mel": mel, "wav": wav, "prof_mel": prof_mel,
                    "prof_wav": prof_wav,
                    "sec": len(wav) / hparams["audio_sample_rate"],
                    "len": mel.shape[0],
                    "prof_sec": len(prof_wav) / hparams["audio_sample_rate"],
                    "prof_len": prof_mel.shape[0]})
        try:
            if binarization_args.get("with_f0"):
                cls.get_pitch(res)
                cls.get_pitch(res, prefix="prof_")
                if binarization_args.get("with_f0cwt"):
                    cls.get_f0cwt(res)
                    cls.get_f0cwt(res, prefix="prof_")
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        except Exception:
            traceback.print_exc()
            return None
        cls.get_pitch_align(res, res["f0"], res["prof_f0"])
        return res


class PopBuTFyENSpkEMBinarizer(PopBuTFyENBinarizer):
    """+ multi_spk_emb: own + spk_emb_num same-song embeddings
    (reference: binarize_para.py:219-260)."""

    def meta_data(self, prefix):
        for m in super().meta_data(prefix):
            yield m + (self.item_names,)

    @classmethod
    def process_item(cls, item_name, wav_fn, spk_id, profwavfn, item_names,
                     binarization_args):
        res = super().process_item(item_name, wav_fn, spk_id, profwavfn,
                                   binarization_args)
        if res is None:
            return None
        song_name = item_name[: -re.search(r"_", item_name[::-1]).span()[0]]
        song_pieces = [s for s in item_names if song_name in s]
        # unseeded, as in the reference: which same-song rows join row 0
        random.shuffle(song_pieces)
        select = song_pieces[: hparams["spk_emb_num"]]
        emb_dir = hparams["spk_emb_data_dir"]
        try:
            multi = [np.load(os.path.join(emb_dir, item_name + ".npy"))]
            for i in range(hparams["spk_emb_num"]):
                pick = select[i] if i < len(select) else select[-1]
                multi.append(np.load(os.path.join(emb_dir, pick + ".npy")))
        except OSError:
            print(f"| Skip item (missing spk emb). item_name: {item_name}")
            return None
        res["multi_spk_emb"] = np.stack(multi, 0)
        return res


class ZhBinarizer(BaseBinarizer):
    """Placeholder for the Chinese text pipeline that
    ``egs/egs_bases/tts/base_zh.yaml`` names; the reference repo lacks it
    too (JAX: ``neuralsvb_tpu/data/binarizer.py:592-596``)."""


class SingingPreAlign:
    """Placeholder for the reference's missing
    ``data_gen.tts.singing.pre_align.SingingPreAlign`` that
    ``egs/egs_bases/singing/base.yaml`` names."""
