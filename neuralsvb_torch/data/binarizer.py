"""Binarizers: raw paired singing wavs -> packed IndexedDataset with mels,
f0, the EHSADTW alignment and speaker embeddings; port of the PopBuTFy path
of ``neuralsvb_tpu/data/binarizer.py`` (reference:
data_gen/tts/base_binarizer.py:26-165, data_gen/singing/binarize.py:19-58,
data_gen/singing/binarize_para.py:25-260).

- ``BaseBinarizer``: glob ``{processed_data_dir}/data/*/*.{mp3,wav}``,
  speaker from ``item_name.split('#')[0] + '#'``, per-split
  IndexedDatasetBuilder, multiprocess ``process_item`` fan-out.
- ``SingingBinarizer``: dataset-regex filter + ``test_prefixes`` split.
- ``SaveSpkEmb``: pass 1, one GE2E embedding per utterance as .npy.
- ``PopBuTFyENBinarizer``: pairs ``*_Amateur_N`` with ``*_Professional_N``,
  rejects pairs with mel gap > ``max_mel_tech_gap``, extracts both f0s and
  the EHSADTW ``a2p_f0_alignment``.
- ``PopBuTFyENSpkEMBinarizer``: pass 2, + ``multi_spk_emb`` = own +
  ``spk_emb_num`` random same-song embeddings from ``spk_emb_data_dir``.

Mel, pitch candidates, the chi-square DTW cost and GE2E run on the
``device`` the hparams name (required); the DTW and Viterbi dynamic
programs run in the host C++ kernel. Not ported yet (ROADMAP.md): the text
branch (``text_labels/``, TextGrids, words) and ``with_f0cwt``; both raise.
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
from copy import deepcopy

import numpy as np
import torch

from ..hparams import hparams, resolve_device
from ..models.ge2e import SpeakerEncoder
from ..ops import dtw as dtw_ops
from ..ops.chi2 import chi2_dist
from ..ops.pitch import get_pitch
from ..vocoders import get_vocoder_cls
from .indexed_dataset import IndexedDatasetBuilder
from .multiprocess import chunked_multiprocess_run


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
        if self.binarization_args.get("with_f0cwt"):
            raise NotImplementedError("with_f0cwt (ops/cwt.py) is not ported yet "
                                      "(ROADMAP.md queue 1 item 7)")
        self.device = resolve_device(hparams.get("device"))
        self.item2wavfn = {}
        self.item2spk = {}
        self.num_workers = int(hparams.get("ds_workers", 1)) or 1
        self.items_per_split = {}
        self.stage_seconds = {}
        self.chi2_launches = 0

    def load_meta_data(self):
        for ds_id, processed_data_dir in enumerate(self.processed_data_dirs):
            if os.path.isdir(f"{processed_data_dir}/text_labels"):
                raise NotImplementedError(
                    f"{processed_data_dir}/text_labels: the text branch of the "
                    "binarizer is not ported yet (ROADMAP.md queue 1 item 7)")
            wav_fns = sorted(glob.glob(f"{processed_data_dir}/data/*/*.mp3")
                             + glob.glob(f"{processed_data_dir}/data/*/*.wav"))
            for wav_fn in wav_fns:
                item_name = os.path.splitext(os.path.basename(wav_fn))[0]
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                self.item2wavfn[item_name] = wav_fn
                spk = item_name.split("#")[0] + "#"
                if len(self.processed_data_dirs) > 1:
                    spk = f"ds{ds_id}_{spk}"
                self.item2spk[item_name] = spk
        self.item_names = sorted(self.item2wavfn.keys())
        print("| Total items:", len(self.item_names))
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)

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
        mel_lengths, f0s = [], []
        total_sec = 0.0
        voice_encoder = self._speaker_encoder() \
            if self.binarization_args.get("with_spk_embed") else None
        args = [list(m) + [self.binarization_args] for m in self.meta_data(prefix)]
        for item in self._run_items(prefix, args):
            if voice_encoder is not None:
                item["spk_embed"] = self._embed(voice_encoder, item["wav"])
            if not self.binarization_args.get("with_wav") and "wav" in item:
                del item["wav"]
                item.pop("prof_wav", None)
            builder.add_item(item)
            mel_lengths.append(max(item["len"], item.get("prof_len", 0)))
            total_sec += item["sec"]
            if item.get("f0") is not None:
                f0s.append(item["f0"])
                if "prof_f0" in item:
                    f0s.append(item["prof_f0"])
        builder.finalize()
        np.save(f"{data_dir}/{prefix}_lengths.npy", mel_lengths)
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

    @classmethod
    def process_item(cls, item_name, wav_fn, spk_id, binarization_args):
        res = {"item_name": item_name, "wav_fn": wav_fn, "spk_id": spk_id}
        wav, mel = _wav2spec(wav_fn)
        res.update({"mel": mel, "wav": wav,
                    "sec": len(wav) / hparams["audio_sample_rate"],
                    "len": mel.shape[0]})
        try:
            if binarization_args.get("with_f0"):
                cls.get_pitch(res)
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        except Exception:
            traceback.print_exc()
            print(f"| Skip item. item_name: {item_name}, wav_fn: {wav_fn}")
            return None
        return res

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
