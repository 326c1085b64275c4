"""The port's multi-window mel discriminator vs the JAX package's on the
same weights (``convert.jax2torch.disc_from_jax``), at tiny widths (hidden 8,
windows 32/64): validities with ``disc_norm`` ``in`` and ``bn``, windows
pinned, in eval mode and in training mode with the dropout masks patched to
all-keep on both sides (the 1/0.75 scaling stays), the BatchNorm running
statistics after a training call, and the abstain case. Tolerance 1e-5."""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_support import agree  # noqa: E402

from neuralsvb_tpu.models import disc as jdisc  # noqa: E402
from neuralsvb_torch.convert.jax2torch import disc_from_jax  # noqa: E402
from neuralsvb_torch.models import common as tcommon  # noqa: E402
from neuralsvb_torch.models import disc as tdisc  # noqa: E402

WINS = (32, 64)
STARTS = [5, 17]


def _mels(B=3, T=96, lens=(96, 90, 70), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, 80).astype(np.float32) - 2
    x *= (np.arange(T)[None, :] < np.asarray(lens)[:, None])[:, :, None]
    return x


def _pair(norm: str, seed: int = 0):
    jm = jdisc.Discriminator(time_lengths=WINS, hidden_size=8, norm_type=norm)
    rngs = {"params": jax.random.PRNGKey(seed), "disc": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    v = jm.init(rngs, np.zeros((2, 128, 80), np.float32), train=True)
    params, stats = v["params"], v.get("batch_stats", {})
    if stats:  # non-trivial running statistics
        rs = np.random.RandomState(seed + 10)
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rs.uniform(0.5, 1.5, a.shape).astype(np.float32)), stats)
    tm = tdisc.Discriminator(WINS, 80, 8, norm)
    tm.load_state_dict(disc_from_jax(jax.device_get(params), jax.device_get(stats)))
    return jm, {"params": params, "batch_stats": stats}, tm


@pytest.fixture
def all_keep(monkeypatch):
    """Dropout keeps every element on both sides (the scaling stays)."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))
    monkeypatch.setattr(tcommon, "dropout_keep_mask",
                        lambda shape, rate, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))


@pytest.mark.parametrize("norm", ["in", "bn"])
def test_eval_validities_match_jax(norm):
    x = _mels()
    jm, v, tm = _pair(norm)
    yj = jm.apply(v, x, start_frames_wins=STARTS)["y"]
    with torch.no_grad():
        yt = tm.eval()(torch.tensor(x), start_frames_wins=STARTS)["y"]
    assert yt.shape == (3, 2)
    agree(yt, yj, 1e-5, f"validity ({norm}, eval)")


@pytest.mark.parametrize("norm", ["in", "bn"])
def test_train_validities_and_stats_match_jax(norm, all_keep):
    x = _mels(seed=1)
    jm, v, tm = _pair(norm, seed=3)
    out, mut = jm.apply(v, x, start_frames_wins=STARTS, train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)},
                        mutable=["batch_stats"])
    tm.train()
    yt = tm(torch.tensor(x), start_frames_wins=STARTS,
            generator=torch.Generator().manual_seed(0))["y"]
    agree(yt, out["y"], 1e-5, f"validity ({norm}, train)")
    if norm == "bn":
        got = disc_from_jax(jax.device_get(v["params"]), jax.device_get(mut["batch_stats"]))
        for k, t in tm.state_dict().items():
            if "running" in k:
                agree(t, got[k].numpy(), 1e-5, k)


def test_train_dropout_draws_from_the_generator():
    """Without the patch the masks are the generator's: one seed, one output."""
    x = torch.tensor(_mels(seed=2))
    _, _, tm = _pair("in")
    tm.train()
    y = [tm(x, start_frames_wins=STARTS, generator=torch.Generator().manual_seed(s))["y"]
         for s in (4, 4, 5)]
    assert torch.equal(y[0], y[1]) and not torch.equal(y[0], y[2])


def test_window_starts_from_the_generator_match_jax_rule():
    """A start is floor(u * (max(x_len) - win + 1)) for the generator's u."""
    x = _mels(lens=(80, 70, 60))
    _, _, tm = _pair("in")
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        starts = tm.eval()(torch.tensor(x), generator=g)["start_frames_wins"]
    u = torch.rand((len(WINS),), generator=torch.Generator().manual_seed(9))
    want = [int(np.floor(float(u[i]) * (80 - w + 1))) for i, w in enumerate(WINS)]
    assert [int(s) for s in starts] == want


def test_abstains_when_a_window_exceeds_the_padded_length():
    x = _mels(B=2, T=48, lens=(48, 40))
    jm, v, tm = _pair("in")
    assert jm.apply(v, x, start_frames_wins=[0, 0])["y"] is None
    assert tm(torch.tensor(x), start_frames_wins=[0, 0])["y"] is None
