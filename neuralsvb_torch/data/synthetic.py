"""Synthetic packed splits in the reference format, for smoke runs, tests
and step timings where no binarized corpus exists.

``write_synthetic_split``: each item is an amateur/professional pair with
the keys ``MultiSpkEmbDataset`` reads: log-mel-like spectrograms, f0 (Hz,
with an unvoiced stretch) and its coarse pitch, a monotonic
professional->amateur frame alignment and a table of speaker embeddings.
``write_synthetic_speech_split``: one side per item with phone tokens and
``phone_set.json``, the keys ``FastSpeechDataset`` reads (the ASR
pre-training recipe). ``write_synthetic_speech_corpus``: raw wavs with
transcripts, the ASR pre-training binarizer's input, and optionally an MFA
TextGrid each (the FastSpeech2 recipes binarize ``with_align``).
``synthetic_crops``: a vocoder training batch of sung vibrato crops.
``chi2_inputs``: the χ² kernel's test histograms (``vibrato_f0``
contours). Everything comes from ``numpy.random.RandomState(seed)``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from ..ops.pitch_utils import f0_to_coarse
from .indexed_dataset import IndexedDatasetBuilder


def _side(rng, T: int, num_mels: int):
    t = np.arange(T)
    f0 = 220.0 * 2 ** (rng.uniform(-0.5, 0.5)) * (1 + 0.02 * np.sin(2 * np.pi * t / 40))
    gap = rng.randint(T // 4, T // 2)
    f0[gap: gap + T // 10] = 0.0
    bins = np.arange(num_mels)[None, :]
    mel = (-4.0 + 1.5 * np.cos(bins / 6.0 + t[:, None] / 25.0)
           + 0.3 * rng.randn(T, num_mels))
    return mel.astype(np.float32), f0


def write_synthetic_split(data_dir: str, frames: Sequence[int], prefix: str = "test",
                          seed: int = 1234, num_mels: int = 80,
                          n_spk_emb: int = 4, spk_emb_dim: int = 256) -> None:
    """Write ``<data_dir>/<prefix>.{data,idx}``, ``<prefix>_lengths.npy`` and
    ``train_f0s_mean_std.npy``; item i has ``frames[i]`` amateur frames and a
    professional side about 10% longer."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    lengths, voiced = [], []
    for i, T_a in enumerate(frames):
        T_p = int(T_a * rng.uniform(1.05, 1.15))
        mel, f0 = _side(rng, T_a, num_mels)
        prof_mel, prof_f0 = _side(rng, T_p, num_mels)
        align = np.round(np.linspace(0, T_a - 1, T_p)).astype(np.int64)
        builder.add_item({
            "item_name": f"Synth#singing#song{i}_Amateur_{i}",
            "mel": mel, "f0": f0, "pitch": f0_to_coarse(f0),
            "prof_mel": prof_mel, "prof_f0": prof_f0,
            "prof_pitch": f0_to_coarse(prof_f0),
            "a2p_f0_alignment": align,
            "multi_spk_emb": rng.randn(n_spk_emb, spk_emb_dim).astype(np.float32),
        })
        lengths.append(T_a)
        voiced += [f0[f0 > 0], prof_f0[prof_f0 > 0]]
    builder.finalize()
    np.save(f"{data_dir}/{prefix}_lengths.npy", np.asarray(lengths))
    v = np.concatenate(voiced)
    np.save(f"{data_dir}/train_f0s_mean_std.npy", np.asarray([v.mean(), v.std()]))


def write_synthetic_speech_split(data_dir: str, frames: Sequence[int], prefix: str = "train",
                                 seed: int = 1234, num_mels: int = 80, n_phones: int = 40,
                                 frames_per_phone: int = 8, mel2ph: bool = False) -> None:
    """Write ``<data_dir>/<prefix>.{data,idx}``, ``<prefix>_lengths.npy``,
    ``train_f0s_mean_std.npy`` and ``phone_set.json`` (``n_phones``
    phones); item i has ``frames[i]`` frames and about one phone token per
    ``frames_per_phone`` frames between ``<BOS>`` and ``<EOS>``; with
    ``mel2ph``, the frames spread evenly over the tokens (FastSpeech2's
    durations) and a speaker id (0 or 1) each."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    phones = ["<BOS>", "<EOS>"] + [f"p{i}" for i in range(n_phones - 2)]
    with open(f"{data_dir}/phone_set.json", "w") as f:
        json.dump(sorted(phones), f)
    ids = {p: i + 4 for i, p in enumerate(sorted(phones))}  # after the 4 reserved ids
    builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
    voiced = []
    for i, T in enumerate(frames):
        mel, f0 = _side(rng, T, num_mels)
        ph = ["<BOS>"] + [f"p{k}" for k in rng.randint(0, n_phones - 2,
                                                        max(T // frames_per_phone, 1))] + ["<EOS>"]
        item = {"item_name": f"Synth#utt{i}", "mel": mel, "f0": f0,
                "pitch": f0_to_coarse(f0), "ph": " ".join(ph), "txt": "",
                "phone": np.asarray([ids[p] for p in ph])}
        if mel2ph:
            item["mel2ph"] = np.arange(T) * len(ph) // T + 1
            item["spk_id"] = i % 2
        builder.add_item(item)
        voiced.append(f0[f0 > 0])
    builder.finalize()
    np.save(f"{data_dir}/{prefix}_lengths.npy", np.asarray(frames))
    v = np.concatenate(voiced)
    np.save(f"{data_dir}/train_f0s_mean_std.npy", np.asarray([v.mean(), v.std()]))


WORDS = ("the a of and to in is it that was he she for on are with as his they be at "
         "one have this from or had by hot word but what some we can out other were all "
         "there when up use your how said an each which do their time if will way about "
         "many then them write would like so these her long make thing see him two has "
         "look more day could go come did number sound no most people my over know water "
         "than call first who may down side been now find Mr. Dr. 3 7 12 42 2024").split()


def write_textgrid(path: str, phones: Sequence[str], seconds: float) -> None:
    """An MFA-style TextGrid of one phone tier: 50 ms of silence, the
    non-silence ``phones`` evenly over the rest, 50 ms of silence."""
    from ..utils.text_encoder import is_sil_phoneme
    phs = [p for p in phones if not is_sil_phoneme(p)]
    edges = np.linspace(0.05, seconds - 0.05, len(phs) + 1)
    ivs = ([(0.0, 0.05, "")] + [(edges[i], edges[i + 1], p) for i, p in enumerate(phs)]
           + [(seconds - 0.05, seconds, "sil")])
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {seconds}", "tiers? <exists>", "size = 1", "item []:",
             "    item [1]:", '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {seconds}",
             f"        intervals: size = {len(ivs)}"]
    for i, (a, b, p) in enumerate(ivs):
        lines += [f"        intervals [{i + 1}]:", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{p}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_synthetic_speech_corpus(processed_dir: str, speakers: int, utterances: int,
                                  seconds=(2.0, 6.0), seed: int = 9, sr: int = 22050,
                                  textgrids: bool = False) -> None:
    """``speakers`` x ``utterances`` wavs of a voiced harmonic tone whose
    pitch glides and wavers, with syllable-rate loudness and short pauses,
    as ``<processed_dir>/data/p1/Spk{s}#utt{u}.wav``, and a random English
    sentence each (numbers and abbreviations among the words) as
    ``text_labels/p1/Spk{s}#utt{u}.txt``; with ``textgrids``, the
    sentence's phones (the English txt_processor's) spread evenly over the
    utterance as ``mfa_outputs/Spk{s}#utt{u}.TextGrid``."""
    from ..ops.audio import save_wav
    data = os.path.join(processed_dir, "data", "p1")
    text = os.path.join(processed_dir, "text_labels", "p1")
    os.makedirs(data)
    os.makedirs(text)
    rng = np.random.RandomState(seed)
    for s in range(speakers):
        for u in range(utterances):
            t = np.arange(int(sr * rng.uniform(*seconds))) / sr
            f0 = 120.0 * (1 + 0.75 * s) * (1 + 0.1 * np.sin(2 * np.pi * 0.3 * t + u)) \
                * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            wav = sum(np.sin(k * phase) / k for k in range(1, 6))
            env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
            env[np.sin(2 * np.pi * 0.45 * t + u) > 0.93] = 0.0  # pauses
            name = f"Spk{s}#utt{u:02d}"
            save_wav(0.15 * wav * env + 0.005 * rng.randn(len(t)),
                     os.path.join(data, f"{name}.wav"), sr)
            sentence = " ".join(rng.choice(WORDS, rng.randint(4, 13))).capitalize() + "."
            with open(os.path.join(text, f"{name}.txt"), "w") as f:
                f.write(sentence)
            if textgrids:
                from .txt_processors import get_txt_processor_cls
                phs, _ = get_txt_processor_cls("en").process(sentence, {})
                mfa = os.path.join(processed_dir, "mfa_outputs")
                os.makedirs(mfa, exist_ok=True)
                write_textgrid(os.path.join(mfa, f"{name}.TextGrid"),
                               ["<BOS>"] + list(phs) + ["<EOS>"], len(t) / sr)


def synthetic_crops(n: int, hp: dict, seed: int = 0) -> dict:
    """``n`` crops of ``max_samples`` sung vibrato with their log-mel and a
    constant f0 each, as the vocoder's collater gives them."""
    import torch
    from ..ops.stft import log_mel_batch
    rng = np.random.RandomState(seed)
    sr, L = hp["audio_sample_rate"], hp["max_samples"]
    f0 = rng.uniform(150, 400, n)
    t = np.arange(L) / sr
    wav = 0.3 * np.sin(2 * np.pi * f0[:, None] * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
    wav = (wav + 0.01 * rng.randn(n, L)).astype(np.float32)
    mel = log_mel_batch(torch.as_tensor(wav), sample_rate=sr, fft_size=hp["fft_size"],
                        hop_size=hp["hop_size"], win_size=hp["win_size"],
                        num_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
                        fmax=float(hp["fmax"]))[:, : L // hp["hop_size"]]
    frames = L // hp["hop_size"]
    return {"wavs": wav, "mels": mel.numpy(), "nsamples": n,
            "f0": np.repeat(f0[:, None], frames, 1).astype(np.float32)}


def vibrato_f0(n: int, period: float, seed: int) -> np.ndarray:
    """A sung f0 contour in Hz: vibrato, jitter and one unvoiced stretch."""
    rng = np.random.RandomState(seed)
    f0 = 220 + 40 * np.sin(2 * np.pi * np.arange(n) / period) + rng.randn(n)
    f0[n // 3: n // 3 + n // 12] = 0.0
    return f0


def chi2_inputs(S: int, T: int, seed: int):
    """Three (a, b) pairs of [S, 48] / [T, 48] f32: the EHSADTW histograms
    of two vibrato contours; random nonnegative rows with all-zero rows;
    and those rows with values outside {0} U [2^-24, 2^24] (1e-30, 1e8 and
    negative, a + b below -0.8) in bins 16-31 of some rows only. A tile of
    the kernel that holds such a row runs its middle 16-bin chunk with `/`
    and its first and last with the branch-free division; a tile that holds
    none runs all three branch-free."""
    from ..ops.dtw import f0_shape_histogram
    sh = f0_shape_histogram(vibrato_f0(S, 50, seed), enhanced=True)
    th = f0_shape_histogram(vibrato_f0(T, 55, seed + 1), enhanced=True,
                            scale_factor=T / S)
    rng = np.random.RandomState(seed)
    a, b = rng.rand(S, 48), rng.rand(T, 48)
    a /= a.sum(1, keepdims=True)
    b /= b.sum(1, keepdims=True)
    a[::7] = 0.0
    b[::5] = 0.0
    oa, ob = a.copy(), b.copy()
    oa[1::97, 16:20] = 1e-30
    ob[2::89, 20:24] = 1e8
    oa[3::151, 24:28] = -1.0 - oa[3::151, 24:28]
    ob[4::113, 28:32] = 1e-30
    return [(sh, th), (a, b), (oa, ob)]
