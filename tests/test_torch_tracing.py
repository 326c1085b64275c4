"""The port's spans (``neuralsvb_torch/utils/profiling.py`` ``span``) on
the CPU: the span store itself, and one ``Trainer._train_one`` step of the
flagship's task and of the vocoder's task at tiny widths, without a
profiler (nothing recorded) and under ``torch.profiler`` (the tree of spans
with its parents, a ``record_function`` event around every record on the
profile's clock, and self times that add up to the step)."""

from __future__ import annotations

import os
import threading

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_support import one_torch_thread  # noqa: E402,F401
from tests.test_torch_vocoder_step import write_vocoder_split  # noqa: E402

from neuralsvb_torch.data.synthetic import write_synthetic_split  # noqa: E402
from neuralsvb_torch.hparams import hparams_scope, set_hparams  # noqa: E402
from neuralsvb_torch.tasks.base_task import DataLoaderLite  # noqa: E402
from neuralsvb_torch.training.trainer import Trainer  # noqa: E402
from neuralsvb_torch.utils import profiling as P  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "svb": (os.path.join(REPO, "egs/datasets/audio/PopBuTFy/vae_global_mle_eng_torch.yaml"),
            dict(hidden_size=32, latent_size=8, fvae_enc_dec_hidden=16, fvae_enc_n_layers=2,
                 fvae_dec_n_layers=2, asr_enc_layers=1, disc_win_num=2,
                 mel_disc_hidden_size=8, collate_bucket_quant=16, pretrain_asr_ckpt="",
                 cache_ppg=False, ds_workers=0)),
    "vocoder": (os.path.join(REPO, "egs/datasets/audio/PopBuTFy/hifigan_nsf_torch.yaml"),
                dict(upsample_rates=[8, 4, 4], upsample_kernel_sizes=[16, 8, 8],
                     upsample_initial_channel=16, resblock_kernel_sizes=[3],
                     resblock_dilation_sizes=[[1, 3]], max_samples=1024, max_sentences=2,
                     disc_start_steps=0, ds_workers=0)),
}
SLACK_US = 50.0
# child -> parent of every span a step records
TREES = {
    "svb": {"train.sync": "train.step", "task.prep_batch": "train.step",
            "update.gen": "train.step", "update.disc": "train.step",
            "update.backward": ("update.gen", "update.disc"),
            "update.optim": ("update.gen", "update.disc"),
            "svb.cond": "update.gen", "svb.asr": "svb.cond", "svb.vae": "update.gen",
            "mel_disc": ("update.gen", "update.disc")},
    "vocoder": {"train.sync": "train.step", "task.prep_batch": "train.step",
                "update.gen": "train.step", "update.disc": "train.step",
                "update.backward": ("update.gen", "update.disc"),
                "update.optim": ("update.gen", "update.disc"),
                "hifigan.source": "update.gen", "hifigan.stage": "update.gen",
                "mel_loss": "update.gen", "mpd": ("update.gen", "update.disc"),
                "msd": ("update.gen", "update.disc")},
}


@pytest.fixture(scope="module", params=["svb", "vocoder"])
def stepped(request, tmp_path_factory):
    """(kind, records of one profiled step, the profile, its trace start in
    ns, records of one step without a profiler)."""
    kind = request.param
    data = str(tmp_path_factory.mktemp(f"tracing_{kind}"))
    if kind == "svb":
        write_synthetic_split(data, (40, 56, 48), prefix="train", seed=3)
        from neuralsvb_torch.tasks.svb_vae_task import SVBVAEMleTask as Task
    else:
        write_vocoder_split(data, (12, 20, 9), "train", 0)
        from neuralsvb_torch.tasks.vocoder_task import HifiGanTask as Task
    config, tiny = RECIPES[kind]
    hp = set_hparams(config=config, hparams_str="device=cpu", print_hparams=False,
                     global_hparams=False)
    with hparams_scope(dict(hp, **tiny, binary_data_dir=data, work_dir="")):
        task = Task()
        trainer = Trainer(work_dir="")
        task.trainer = trainer
        task.build_model()
        task.build_train()
        trainer._set_step(task, 1)
        loader = iter(task.train_dataloader())
        trainer._train_one(task, next(loader))  # warm: first-call paths
        P.clear()
        trainer._train_one(task, next(loader))
        off = P.spans()
        batch = next(loader)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer._train_one(task, batch)
        recs = P.spans()
        P.clear()
    return kind, recs, prof, prof.profiler.kineto_results.trace_start_ns(), off


def test_a_step_without_a_profiler_records_nothing(stepped):
    assert stepped[4] == []


def test_a_profiled_step_records_the_tree(stepped):
    kind, recs = stepped[:2]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in recs)
    assert {r.name for r in recs} == {"train.step", *TREES[kind]}
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == ["train.step"]
    for r in recs[1:]:
        want = TREES[kind][r.name]
        assert recs[r.parent].name in ((want,) if isinstance(want, str) else want), r
        assert recs[r.parent].start_ns <= r.start_ns and r.end_ns <= recs[r.parent].end_ns
    names = [r.name for r in recs]
    assert names.count("train.sync") == 2
    assert names.count("update.backward") == names.count("update.optim") == 2
    if kind == "vocoder":
        assert names.count("hifigan.stage") == 3 and names.count("mel_loss") == 2


def test_every_record_lies_in_its_profile_event(stepped):
    """Each record has a ``record_function`` event of its name around it on
    the profile's clock (``time.time_ns()`` less the trace's start), within
    ``SLACK_US``; records and events of a name pair off in order."""
    _, recs, prof, t0, _ = stepped
    events = {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            events.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    for name in {r.name for r in recs}:
        mine = sorted(((r.start_ns - t0) * 1e-3, (r.end_ns - t0) * 1e-3)
                      for r in recs if r.name == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (s, e), (es, ee) in zip(mine, theirs):
            assert es - SLACK_US <= s and e <= ee + SLACK_US, (name, s, e, es, ee)


def test_span_table_self_times_add_up(stepped):
    recs = stepped[1]
    table = P.span_table(recs)
    step = table["train.step"]
    assert step["count"] == 1
    assert sum(v["self_ms"] for v in table.values()) == pytest.approx(step["total_ms"],
                                                                       rel=1e-9)
    assert all(v["self_ms"] >= 0 for v in table.values())
    assert table["update.gen"]["self_ms"] < table["update.gen"]["total_ms"]


def test_spans_record_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    s = P.span("outer")

    @P.span("inner")
    def inner(x):
        return x + 1

    P.clear()
    with s:
        assert inner(1) == 2
    assert P.spans() == [] and P.span_table() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with s:
            inner(1)
            with s:  # one instance, re-entered
                inner(2)
    recs = P.spans()
    assert [(r.name, r.parent) for r in recs] == [("outer", -1), ("inner", 0), ("outer", 0),
                                                  ("inner", 2)]
    t = P.span_table()
    assert t["outer"]["count"] == 2 and t["inner"]["count"] == 2
    P.clear()
    assert P.spans() == [] and P.dropped_spans() == 0


def test_the_store_is_capped_and_threads_keep_their_own_parents(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(P, "SPAN_CAP", 3)
    P.clear()
    seen = {}

    def worker():
        with P.span("thread.outer"):
            with P.span("thread.inner"):
                seen["tid"] = threading.get_ident()

    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            for _ in range(3):
                with P.span("past.cap"):
                    pass
    recs = P.spans()
    assert len(recs) == 3 and P.dropped_spans() == 3
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert by["main"][1].parent == -1 and by["thread.outer"][1].parent == -1
    assert by["thread.inner"][1].parent == by["thread.outer"][0]
    assert by["thread.inner"][1].thread == seen["tid"] != by["main"][1].thread
    P.clear()


def test_the_prefetching_loader_records_its_wait():
    from torch.profiler import ProfilerActivity, profile

    class Items:
        def __getitem__(self, i):
            return i

        def collater(self, items):
            return {"ids": list(items)}

    P.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [b["ids"] for b in DataLoaderLite(Items(), [[0, 1], [2]], prefetch=2)]
    assert got == [[0, 1], [2]]
    # one wait per batch and one for the end of the stream
    assert [(r.name, r.parent) for r in P.spans()] == [("data.wait", -1)] * 3
    P.clear()


def test_clearing_inside_an_open_span_leaves_no_stale_parent():
    from torch.profiler import ProfilerActivity, profile
    P.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("outer"):  # record 0 of the store that clear() empties
            P.clear()
            with P.span("first"):  # record 0 of the new store
                with P.span("inner"):
                    pass
    assert [(r.name, r.parent) for r in P.spans()] == [("first", -1), ("inner", 0)]
    t = P.span_table()
    assert "outer" not in t
    assert 0 <= t["first"]["self_ms"] <= t["first"]["total_ms"]
    P.clear()
