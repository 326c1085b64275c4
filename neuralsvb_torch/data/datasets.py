"""Datasets over packed IndexedDatasets, producing numpy batches; port of the
SVB, speech and FastSpeech2 paths of ``neuralsvb_tpu/data/datasets.py``
(reference: tasks/tts/dataset_utils.py:15-236, tasks/singing/neural_svb_task.py:10-86,
tasks/singing/svb_vae_task.py:20-45, tasks/singing/svb_para.py:19-49).

Samples are numpy dicts and stay on the host; the task moves a collated
batch to its device in one step. Mels crop to ``max_frames`` then floor to a
multiple of ``frames_multiple``; the collater pads time axes up to a
multiple of ``collate_bucket_quant`` (default ``8 * frames_multiple``);
phone tokens pad to the batch's longest.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..hparams import hparams as global_hparams
from ..ops.pitch_utils import f0_to_coarse, norm_interp_f0
from .batching import collate_1d, collate_2d, ordered_indices
from .indexed_dataset import IndexedDataset


class BaseDataset:
    def __init__(self, shuffle: bool = False, hp: Optional[dict] = None):
        self.hparams = hp if hp is not None else global_hparams
        self.shuffle = shuffle
        self.sort_by_len = self.hparams.get("sort_by_len", True)
        self.sizes = None
        self._rng = np.random.RandomState(self.hparams.get("seed", 1234))

    def __getitem__(self, index):
        raise NotImplementedError

    def collater(self, samples):
        raise NotImplementedError

    def __len__(self):
        return len(self.sizes)

    def num_tokens(self, index):
        return self.size(index)

    def size(self, index):
        return min(self.sizes[index], self.hparams["max_frames"])

    def ordered_indices(self):
        return ordered_indices(self.sizes, self.shuffle, self.sort_by_len, self._rng)

    @property
    def bucket_quant(self):
        return int(self.hparams.get("collate_bucket_quant",
                                    8 * self.hparams.get("frames_multiple", 1)))


class BaseConcatDataset(BaseDataset):
    """Datasets concatenated under the first one's collater: multi-dataset
    training (JAX: ``BaseConcatDataset``, ``neuralsvb_tpu/data/datasets.py:58-88``;
    reference: tasks/base_task.py:99-128). The index space is cumulative;
    ``sizes`` chain the members' and ``ordered_indices`` shuffles (and sorts
    by length) over the whole, from the concatenation's own stream. Items
    keep their member-local ``id``."""

    def __init__(self, datasets: List["BaseDataset"]):
        if not datasets:
            raise ValueError("need at least one dataset")
        super().__init__(shuffle=datasets[0].shuffle, hp=datasets[0].hparams)
        self.datasets = list(datasets)
        self.sort_by_len = datasets[0].sort_by_len
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])
        self.sizes = [s for d in self.datasets for s in d.sizes]

    def _locate(self, index):
        ds_idx = int(np.searchsorted(self.cumulative_sizes, index, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cumulative_sizes[ds_idx - 1])
        return ds_idx, index - prev

    def __getitem__(self, index):
        ds_idx, local = self._locate(index)
        return self.datasets[ds_idx][local]

    def collater(self, samples):
        return self.datasets[0].collater(samples)


def maybe_concat_dataset(dataset_cls, prefix: str, shuffle: bool, hp=None):
    """One ``dataset_cls`` per entry of ``binary_data_dirs``, concatenated,
    when it is set; otherwise one over ``binary_data_dir`` (JAX:
    ``maybe_concat_dataset``, ``datasets.py:91-99``)."""
    hp = hp if hp is not None else global_hparams
    dirs = hp.get("binary_data_dirs") or []
    if not dirs:
        return dataset_cls(prefix, shuffle=shuffle)
    return BaseConcatDataset([dataset_cls(prefix, shuffle=shuffle, data_dir=d) for d in dirs])


class BaseTTSDataset(BaseDataset):
    def __init__(self, prefix: str, shuffle: bool = False, data_dir=None, hp=None):
        super().__init__(shuffle, hp)
        hp = self.hparams
        self.data_dir = hp["binary_data_dir"] if data_dir is None else data_dir
        self.prefix = prefix
        self.indexed_ds = None
        self.sizes = np.load(f"{self.data_dir}/{prefix}_lengths.npy").tolist()
        if (prefix == "test" or hp.get("infer")) and hp.get("num_test_samples", 0) > 0:
            self.avail_idxs = [x for x in range(hp["num_test_samples"])
                               if x < len(self.sizes)]
            self.avail_idxs = list(hp.get("test_ids", [])) + self.avail_idxs
        else:
            self.avail_idxs = list(range(len(self.sizes)))
        if hp.get("min_frames", 0) > 0:
            self.avail_idxs = [x for x in self.avail_idxs
                               if self.sizes[x] >= hp["min_frames"]]
        self.sizes = [self.sizes[i] for i in self.avail_idxs]

    def _get_item(self, index):
        index = self.avail_idxs[index]
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(f"{self.data_dir}/{self.prefix}")
        return self.indexed_ds[index]

    def _crop(self, arr):
        hp = self.hparams
        arr = np.asarray(arr)[: hp["max_frames"]]
        fm = hp.get("frames_multiple", 1)
        return arr[: len(arr) // fm * fm]

    def __getitem__(self, index):
        hp = self.hparams
        item = self._get_item(index)
        sample = {"id": index, "item_name": item["item_name"], "text": item.get("txt"),
                  "mel": self._crop(item["mel"]).astype(np.float32)}
        if item.get("phone") is not None:
            sample["txt_token"] = np.asarray(item["phone"][: hp["max_input_tokens"]],
                                             np.int64)
        if hp.get("use_spk_embed"):
            sample["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if hp.get("use_spk_id"):
            sample["spk_id"] = item["spk_id"]
        return sample

    def collater(self, samples: List[dict]) -> Dict:
        if not samples:
            return {}
        hp = self.hparams
        bq = self.bucket_quant
        batch = {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "item_name": [s["item_name"] for s in samples],
            "nsamples": len(samples),
            "text": [s["text"] for s in samples],
            "mels": collate_2d([s["mel"] for s in samples], 0.0, bucket_quant=bq),
            "mel_lengths": np.asarray([len(s["mel"]) for s in samples], np.int64),
        }
        if samples[0].get("txt_token") is not None:
            batch["txt_tokens"] = collate_1d([s["txt_token"] for s in samples], 0)
            batch["txt_lengths"] = np.asarray([len(s["txt_token"]) for s in samples],
                                              np.int64)
        if hp.get("use_spk_embed"):
            batch["spk_embed"] = np.stack([s["spk_embed"] for s in samples])
        if hp.get("use_spk_id"):
            batch["spk_ids"] = np.asarray([s["spk_id"] for s in samples], np.int64)
        return batch


class FastSpeechDataset(BaseTTSDataset):
    """Adds energy, ``mel2ph``, the normalized f0 with uv and the coarse
    pitch (zeros and no pitch with ``use_pitch_embed: false``) and, with
    ``pitch_type: cwt``, the packed ``cwt_spec`` with the utterance's
    ``f0_mean``/``f0_std``. ``train_f0s_mean_std.npy`` of the data dir sets
    the ``f0_mean``/``f0_std`` hparams and attributes."""

    def __init__(self, prefix, shuffle=False, data_dir=None, hp=None):
        super().__init__(prefix, shuffle, data_dir, hp)
        stats_fn = f"{self.data_dir}/train_f0s_mean_std.npy"
        if os.path.exists(stats_fn):
            mean, std = np.load(stats_fn)
            self.hparams["f0_mean"] = self.f0_mean = float(mean)
            self.hparams["f0_std"] = self.f0_std = float(std)
        else:
            self.f0_mean = self.hparams.get("f0_mean")
            self.f0_std = self.hparams.get("f0_std")
        self.pitch_type = self.hparams.get("pitch_type")

    def _pitch_sample(self, item, max_frames, prefix=""):
        hp = self.hparams
        f0_raw = np.asarray(item[f"{prefix}f0"], np.float64)
        if hp.get("normalize_pitch", False):
            f0 = f0_raw.copy()
            v = f0 > 0
            if v.any() and f0[v].std() > 0:
                f0[v] = ((f0[v] - f0[v].mean()) / f0[v].std() * hp["f0_std"]
                         + hp["f0_mean"])
                hi = 900 if prefix else 500
                f0[v] = f0[v].clip(60, hi)
            pitch = f0_to_coarse(f0)[:max_frames].astype(np.int64)
        else:
            pitch = (np.asarray(item[f"{prefix}pitch"], np.int64)[:max_frames]
                     if f"{prefix}pitch" in item else None)
        f0, uv = norm_interp_f0(f0_raw[:max_frames], hp)
        return f0.astype(np.float32), uv.astype(np.float32), pitch

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        item = self._get_item(index)
        spec = sample["mel"]
        max_frames = len(spec)
        sample["energy"] = np.sqrt((np.exp(spec) ** 2).sum(-1)).astype(np.float32)
        sample["mel2ph"] = (np.asarray(item["mel2ph"], np.int64)[:max_frames]
                            if "mel2ph" in item else None)
        if self.hparams.get("use_pitch_embed", True):
            f0, uv, pitch = self._pitch_sample(item, max_frames)
            sample["f0"], sample["uv"], sample["pitch"] = f0, uv, pitch
            if self.pitch_type == "cwt" and "cwt_spec" in item:
                sample["cwt_spec"] = np.asarray(item["cwt_spec"], np.float32)[:max_frames]
                sample["f0_mean"] = item.get("f0_mean", item.get("cwt_mean"))
                sample["f0_std"] = item.get("f0_std", item.get("cwt_std"))
        else:
            sample["f0"] = sample["uv"] = np.zeros(max_frames, np.float32)
            sample["pitch"] = None
        return sample

    def collater(self, samples):
        if not samples:
            return {}
        batch = super().collater(samples)
        bq = self.bucket_quant
        batch["f0"] = collate_1d([s["f0"] for s in samples], 0.0, bucket_quant=bq)
        batch["pitch"] = (collate_1d([s["pitch"] for s in samples], 0, bucket_quant=bq)
                          if samples[0]["pitch"] is not None else None)
        batch["uv"] = collate_1d([s["uv"] for s in samples], 0.0, bucket_quant=bq)
        batch["energy"] = collate_1d([s["energy"] for s in samples], 0.0, bucket_quant=bq)
        batch["mel2ph"] = (collate_1d([s["mel2ph"] for s in samples], 0, bucket_quant=bq)
                           if samples[0]["mel2ph"] is not None else None)
        if self.pitch_type == "cwt" and "cwt_spec" in samples[0]:
            batch["cwt_spec"] = collate_2d([s["cwt_spec"] for s in samples], bucket_quant=bq)
            batch["f0_mean"] = np.asarray([s["f0_mean"] for s in samples], np.float32)
            batch["f0_std"] = np.asarray([s["f0_std"] for s in samples], np.float32)
        return batch


class FastSingingDataset(FastSpeechDataset):
    """Adds the prof_* (professional) side
    (reference: tasks/singing/neural_svb_task.py:10-62)."""

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        item = self._get_item(index)
        prof_spec = self._crop(item["prof_mel"]).astype(np.float32)
        max_frames = len(prof_spec)
        sample["prof_mel"] = prof_spec
        sample["prof_energy"] = np.sqrt((np.exp(prof_spec) ** 2).sum(-1)).astype(np.float32)
        sample["prof_mel2ph"] = (np.asarray(item["prof_mel2ph"], np.int64)[:max_frames]
                                 if "prof_mel2ph" in item else None)
        f0, uv, pitch = self._pitch_sample(item, max_frames, prefix="prof_")
        sample["prof_f0"], sample["prof_uv"], sample["prof_pitch"] = f0, uv, pitch
        return sample

    def collater(self, samples):
        if not samples:
            return {}
        batch = super().collater(samples)
        bq = self.bucket_quant
        batch["prof_f0"] = collate_1d([s["prof_f0"] for s in samples], 0.0,
                                      bucket_quant=bq)
        batch["prof_pitch"] = collate_1d([s["prof_pitch"] for s in samples], 0,
                                         bucket_quant=bq)
        batch["prof_uv"] = collate_1d([s["prof_uv"] for s in samples], 0.0,
                                      bucket_quant=bq)
        batch["prof_energy"] = collate_1d([s["prof_energy"] for s in samples], 0.0,
                                          bucket_quant=bq)
        batch["prof_mels"] = collate_2d([s["prof_mel"] for s in samples], 0.0,
                                        bucket_quant=bq)
        batch["prof_mel_lengths"] = np.asarray(
            [len(s["prof_mel"]) for s in samples], np.int64)
        # an item binarized without alignment gives an all-0 row (0 = no
        # phone), as in the JAX package
        m2p = [s["prof_mel2ph"] for s in samples]
        batch["prof_mel2ph"] = (
            collate_1d([np.zeros(len(s["prof_mel"]), np.int64) if v is None else v
                        for s, v in zip(samples, m2p)], 0, bucket_quant=bq)
            if any(v is not None for v in m2p) else None)
        return batch


class MultiSpkEmbDataset(FastSingingDataset):
    """Adds a2p_f0_alignment + multi_spk_emb
    (reference: tasks/singing/svb_vae_task.py:20-45)."""

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        item = self._get_item(index)
        T_p = len(sample["prof_pitch"])
        T_a = len(sample["pitch"])
        align = np.asarray(item["a2p_f0_alignment"], np.int64)[:T_p].clip(max=T_a - 1)
        if align.shape != sample["prof_pitch"].shape:
            raise ValueError(f"a2p alignment shape {align.shape} != prof pitch "
                             f"shape {sample['prof_pitch'].shape}")
        sample["a2p_f0_alignment"] = align
        sample["multi_spk_emb"] = np.asarray(item["multi_spk_emb"], np.float32)
        return sample

    def collater(self, samples):
        if not samples:
            return {}
        batch = super().collater(samples)
        batch["a2p_f0_alignment"] = collate_1d(
            [s["a2p_f0_alignment"] for s in samples], 0, bucket_quant=self.bucket_quant)
        batch["multi_spk_emb"] = np.stack([s["multi_spk_emb"] for s in samples])
        return batch


class FastSingingF0AlignDataset(FastSingingDataset):
    """Both alignments for the SVBPara task family (reference:
    tasks/singing/svb_para.py:19-49): ``a2p_f0_alignment`` and, where
    packed, ``p2a_f0_alignment`` and ``multi_spk_emb``."""

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        item = self._get_item(index)
        T_p, T_a = len(sample["prof_pitch"]), len(sample["pitch"])
        sample["a2p_f0_alignment"] = np.asarray(
            item["a2p_f0_alignment"], np.int64)[:T_p].clip(max=T_a - 1)
        if "p2a_f0_alignment" in item:
            sample["p2a_f0_alignment"] = np.asarray(
                item["p2a_f0_alignment"], np.int64)[:T_a].clip(max=T_p - 1)
        if "multi_spk_emb" in item:
            sample["multi_spk_emb"] = np.asarray(item["multi_spk_emb"], np.float32)
        return sample

    def collater(self, samples):
        if not samples:
            return {}
        batch = super().collater(samples)
        bq = self.bucket_quant
        batch["a2p_f0_alignment"] = collate_1d(
            [s["a2p_f0_alignment"] for s in samples], 0, bucket_quant=bq)
        if "p2a_f0_alignment" in samples[0]:
            batch["p2a_f0_alignment"] = collate_1d(
                [s["p2a_f0_alignment"] for s in samples], 0, bucket_quant=bq)
        if "multi_spk_emb" in samples[0]:
            batch["multi_spk_emb"] = np.stack([s["multi_spk_emb"] for s in samples])
        return batch


class FastSpeechWordDataset(FastSpeechDataset):
    """Word-level inputs (reference: tasks/tts/dataset_utils.py:211-236):
    adds ``words``, ``word_tokens``, ``mel2word`` and ``ph2word`` where the
    items carry them (the binarizer's ``with_word``); with
    ``use_word_input`` the word tokens and ``mel2word`` stand in for the
    phone tokens and ``mel2ph``."""

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        item = self._get_item(index)
        max_frames = len(sample["mel"])
        if "words" in item:
            sample["words"] = item["words"]
            sample["ph_words"] = item.get("ph_words")
        if "word_tokens" in item:
            sample["word_tokens"] = np.asarray(item["word_tokens"], np.int64)
        if "mel2word" in item:
            sample["mel2word"] = np.asarray(item["mel2word"], np.int64)[:max_frames]
        if "ph2word" in item:
            sample["ph2word"] = np.asarray(item["ph2word"][: self.hparams["max_input_tokens"]],
                                           np.int64)
        return sample

    def collater(self, samples):
        if not samples:
            return {}
        batch = super().collater(samples)
        bq = self.bucket_quant
        if "word_tokens" in samples[0]:
            batch["word_tokens"] = collate_1d([s["word_tokens"] for s in samples], 0)
            batch["word_lengths"] = np.asarray([len(s["word_tokens"]) for s in samples],
                                               np.int64)
        if "mel2word" in samples[0]:
            batch["mel2word"] = collate_1d([s["mel2word"] for s in samples], 0, bucket_quant=bq)
        if "ph2word" in samples[0]:
            batch["ph2word"] = collate_1d([s["ph2word"] for s in samples], 0)
        if "words" in samples[0]:
            batch["words"] = [s["words"] for s in samples]
        if self.hparams.get("use_word_input") and "word_tokens" in batch:
            batch["txt_tokens"] = batch["word_tokens"]
            batch["txt_lengths"] = batch["word_lengths"]
            if "mel2word" in batch:
                batch["mel2ph"] = batch["mel2word"]
        return batch
