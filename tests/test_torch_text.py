"""The port's text branch against the JAX package's: text normalisation,
the token encoder, the text processors and TextGrid alignment on the same
strings, and the ``BaseBinarizer`` text branch end to end on the same wavs,
transcripts and TextGrids (in-process on both sides).

Text outputs must be equal. Binarized items: ``phone``, ``ph``, ``txt``,
``mel2ph``, ``dur`` and the word packing equal, ``phone_set.json`` and
``word_set.json`` identical, ``mel`` within 1e-5, ``f0`` within 1 Hz and
``pitch`` equal on >= 99% of frames (the binarize path's own tolerances,
``tests/test_torch_binarize_e2e.py``)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neuralsvb_tpu.data import textgrid as jtg  # noqa: E402
from neuralsvb_tpu.data import txt_processors as jtxt  # noqa: E402
from neuralsvb_tpu.utils import text_encoder as jenc  # noqa: E402
from neuralsvb_tpu.utils import text_norm as jnorm  # noqa: E402
from neuralsvb_torch.data import textgrid as ttg  # noqa: E402
from neuralsvb_torch.data import txt_processors as ttxt  # noqa: E402
from neuralsvb_torch.utils import text_encoder as tenc  # noqa: E402
from neuralsvb_torch.utils import text_norm as tnorm  # noqa: E402

EN = ["Hello there, Mr. Smith!", "I saw 3 birds and 1,024 bees; Dr. Who (the 2nd).",
      "It costs 2000000 dollars", "  spaces   and\ttabs  ", "St. Jr. Capt. Ltd. 19 99 100"]
ZH = ["今天是2021年3月15日，我花了12.5元。", "电话13812345678或010-12345678",
      "增长了35%，约3/4的人", "他有2个苹果和10000本书", "O2O和B2C", "第12345678号"]
SR = 22050


@pytest.mark.parametrize("text", EN)
def test_english_norm_and_processor(text):
    assert tnorm.normalize_en(text) == jnorm.normalize_en(text)
    assert tnorm.NormalizeText()(text, "en") == jnorm.NormalizeText()(text, "en")
    assert ttxt.get_txt_processor_cls("en").process(text) == \
        jtxt.get_txt_processor_cls("en").process(text)


@pytest.mark.parametrize("text", ZH)
def test_chinese_norm_and_processor(text):
    assert tnorm.normalize_zh(text) == jnorm.normalize_zh(text)
    assert tnorm.NSWNormalizer(text).normalize() == jnorm.NSWNormalizer(text).normalize()
    assert ttxt.get_txt_processor_cls("zh").process(text) == \
        jtxt.get_txt_processor_cls("zh").process(text)
    for n in ("0", "10", "12", "102", "20000", "-3.05", "1000010"):
        assert tnorm.zh_cardinal(n) == jnorm.zh_cardinal(n)


def test_zh_g2pm_is_gated_alike():
    """``zh_g2pM`` needs jieba/g2pM; both packages raise the same error
    where they are missing, and its pure post-processing agrees."""
    errs = []
    for mod in (ttxt, jtxt):
        try:
            mod.get_txt_processor_cls("zh_g2pM").process("你好")
            errs.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            errs.append(type(e))
    assert errs[0] == errs[1]
    assert set(ttxt.REGISTERED_TEXT_PROCESSORS) == set(jtxt.REGISTERED_TEXT_PROCESSORS)
    args = (["ni3", "hao3", "shi4", "zhang1"], "ab#cd")
    assert ttxt.zh_g2pm_phoneme_seq(*args) == jtxt.zh_g2pm_phoneme_seq(*args)
    ph = ["ni3", "hao3", "ma5", "zhang1", "a1", "er2"]
    assert [ttxt.split_shenmu(p) for p in ph] == [jtxt.split_shenmu(p) for p in ph]


def test_token_encoder():
    phones = ["a", "b", "|", "<BOS>", "<EOS>", ",", "zh"]
    t = tenc.TokenTextEncoder(None, vocab_list=phones, replace_oov=",")
    j = jenc.TokenTextEncoder(None, vocab_list=phones, replace_oov=",")
    s = "<BOS> a zh | q b <EOS>"
    assert t.encode(s) == j.encode(s)
    ids = t.encode(s) + [0, 0]
    assert t.decode(ids, strip_padding=True) == j.decode(ids, strip_padding=True)
    assert t.sil_phonemes() == j.sil_phonemes()
    assert (t.pad(), t.eos(), t.unk(), t.seg(), len(t)) == \
        (j.pad(), j.eos(), j.unk(), j.seg(), len(j))
    assert [tenc.is_sil_phoneme(p) for p in phones + [""]] == \
        [jenc.is_sil_phoneme(p) for p in phones + [""]]


def write_textgrid(path, phones, seconds):
    """An MFA-style TextGrid: silence, the non-silence phones evenly over
    the utterance, silence."""
    phs = [p for p in phones if not tenc.is_sil_phoneme(p)]
    edges = np.linspace(0.05, seconds - 0.05, len(phs) + 1)
    ivs = [(0.0, 0.05, "")] + [(edges[i], edges[i + 1], p) for i, p in enumerate(phs)] \
        + [(seconds - 0.05, seconds, "sil")]
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


def test_textgrid_mel2ph():
    phones = "<BOS> h i | t h e r e <EOS>".split(" ")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        fn = os.path.join(d, "a.TextGrid")
        write_textgrid(fn, phones, 1.0)
        mel = np.zeros((173, 80), np.float32)
        hp = {"audio_sample_rate": SR, "hop_size": 128}
        with open(fn) as f:
            text = f.read()
        assert ttg.parse_textgrid(text) == jtg.parse_textgrid(text)
        t, j = ttg.get_mel2ph(fn, " ".join(phones), mel, hp), \
            jtg.get_mel2ph(fn, " ".join(phones), mel, hp)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])


SENTENCES = ("Hello there, Mr. Smith.", "I saw 3 birds today!", "Good night.",
             "We sing; they dance.")


@pytest.fixture(scope="module", params=[False, True], ids=["untrimmed", "trim_eos_bos"])
def binarized(tmp_path_factory, request):
    """Four utterances of two speakers with transcripts and TextGrids,
    binarized by both packages (with_align, with_word; with and without
    ``trim_eos_bos``)."""
    from neuralsvb_torch.ops.audio import save_wav
    root = tmp_path_factory.mktemp("text_bin")
    data, text, mfa = (root / "processed" / "data" / "p1",
                       root / "processed" / "text_labels" / "p1", root / "processed" / "mfa_outputs")
    for d in (data, text, mfa):
        d.mkdir(parents=True)
    for i, s in enumerate(SENTENCES):
        rng = np.random.RandomState(i)
        sec = 0.9 + 0.1 * i
        t = np.arange(int(SR * sec)) / SR
        f = 150.0 * (1 + 0.2 * (i % 2)) * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
        name = f"Spk{i % 2}#utt{i}"
        save_wav(0.3 * np.sin(2 * np.pi * np.cumsum(f) / SR) + 0.01 * rng.randn(len(t)),
                 str(data / f"{name}.wav"), SR)
        (text / f"{name}.txt").write_text(s)
        phs, _ = ttxt.get_txt_processor_cls("en").process(s)
        write_textgrid(str(mfa / f"{name}.TextGrid"), ["<BOS>"] + phs + ["<EOS>"], sec)
    hp = {"processed_data_dir": str(root / "processed"), "test_num": 1, "num_spk": 10,
          "binarization_args": {"with_f0": True, "with_txt": True, "with_align": True,
                                "with_word": True, "with_wav": False, "shuffle": False,
                                "reset_phone_dict": True, "reset_word_dict": True,
                                "trim_eos_bos": request.param},
          "pre_align_args": {"txt_processor": "en"}, "word_size": 30000,
          "audio_sample_rate": SR, "fft_size": 512, "hop_size": 128, "win_size": 512,
          "audio_num_mel_bins": 80, "fmin": 50, "fmax": 11025, "ds_workers": 1,
          "vocoder": "pwg", "vocoder_ckpt": "", "pitch_extractor": "autocorr"}
    from neuralsvb_torch.data.binarizer import BaseBinarizer as TB
    from neuralsvb_torch.hparams import hparams_scope as t_scope
    with t_scope(dict(hp, binary_data_dir=str(root / "port"), device="cpu")):
        TB().process()
    from neuralsvb_tpu.data.binarizer import BaseBinarizer as JB
    from neuralsvb_tpu.hparams import hparams_scope as j_scope
    with j_scope(dict(hp, binary_data_dir=str(root / "jax"))):
        JB().process()
    return root


def _items(root, out, prefix):
    from neuralsvb_torch.data.indexed_dataset import IndexedDataset
    ds = IndexedDataset(str(root / out / prefix))
    return [ds[i] for i in range(len(ds))]


def test_binarizer_text_branch_matches_jax(binarized):
    root = binarized
    for fn in ("phone_set.json", "word_set.json", "spk_map.json"):
        assert json.loads((root / "port" / fn).read_text()) == \
            json.loads((root / "jax" / fn).read_text()), fn
    for prefix, n in (("train", 3), ("valid", 1)):
        t, j = _items(root, "port", prefix), _items(root, "jax", prefix)
        assert len(t) == len(j) == n
        for a, b in zip(t, j):
            assert a["item_name"] == b["item_name"]
            for k in ("ph", "txt", "words", "ph_words", "ph2word", "mel2word", "dur_word",
                      "word_tokens", "ph_len"):
                assert a[k] == b[k], k
            for k in ("phone", "mel2ph", "dur"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.abs(a["mel"] - b["mel"]).max() <= 1e-5
            assert np.abs(a["f0"] - b["f0"]).max() <= 1.0
            assert (a["pitch"] == b["pitch"]).mean() >= 0.99
            assert a["mel2ph"].min() >= 1 and a["dur"].sum() == len(a["mel"])
        np.testing.assert_array_equal(np.load(root / "port" / f"{prefix}_ph_lengths.npy"),
                                      np.load(root / "jax" / f"{prefix}_ph_lengths.npy"))
