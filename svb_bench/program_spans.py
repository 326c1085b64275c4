"""The program's own spans (``neuralsvb_torch.utils.profiling.span``) in a
``--trace 1`` run of a training cell, read after the kind has returned.

The program records its spans only while the profiler is on, so its store
holds the traced steps alone. Host times are per step: each part of the
split's total over the number of ``train.step`` records. A part's time is
its spans' durations less the other parts' spans nested in them, so the
forward is what an update span holds besides its backward and its
optimizer, and the parts add up to at most the step.

Counts read the profile's runtime calls inside each ``train.step``, which
needs the spans on the trace's clock. The records carry
``time.time_ns()``; the trace's times are microseconds since its start. The
offset is the least, over the traced steps, of the program's ``train.step``
start less the harness's ``train_one`` start. After the shift every
``train.step`` has to lie inside its ``train_one`` within ``SLACK_US``:
else nothing is read. A program without the span store (an older
checkout) gives nothing too."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

STEP = "train.step"
# span name -> part of the step it is charged to
PARTS = {"task.prep_batch": "prep", "update.gen": "forward", "update.disc": "forward",
         "update.map": "forward", "update.backward": "backward", "update.optim": "optim",
         "train.sync": "sync_wait"}
SLACK_US = 50.0
# kernel launches (``cudaLaunchKernel*`` and ``cuLaunchKernel*``, every
# variant), and the calls that block the host until the card has caught up
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
SYNC = re.compile(r"^(cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize"
                  r"|cudaMemcpy(_v\d+)?$)")


def records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from neuralsvb_torch.utils import profiling
        return profiling.spans()
    except (ImportError, AttributeError):
        return None


def _parts_ms(recs, roots) -> Dict[str, float]:
    """Milliseconds by part of the spans under the ``train.step`` records
    ``roots``, each span less the parts' spans nested in it. A parent's
    record comes before its children's."""
    out = {p: 0.0 for p in PARTS.values()}
    root, charged = [-1] * len(recs), [-1] * len(recs)
    for i, r in enumerate(recs):
        j = r.parent
        if 0 <= j < i:
            root[i] = root[j]
            charged[i] = j if recs[j].name in PARTS else charged[j]
        if i in roots:
            root[i] = i
        part = PARTS.get(r.name)
        if part is None or r.end_ns is None or root[i] < 0:
            continue
        ms = (r.end_ns - r.start_ns) * 1e-6
        out[part] += ms
        if charged[i] >= 0:
            out[PARTS[recs[charged[i]].name]] -= ms
    return out


def aligned_steps(res, steps) -> Optional[List[Tuple[float, float]]]:
    """The ``train.step`` records ``steps`` as intervals on the trace's
    clock (µs), or None where they cannot be placed inside the harness's
    ``train_one`` spans."""
    ones = sorted((s, e) for n, s, e in res.trace.spans if n == "train_one")
    if not steps or len(steps) != len(ones):
        return None
    us = [(r.start_ns * 1e-3, r.end_ns * 1e-3) for r in steps]
    offset = min(s - h for (s, _), (h, _) in zip(us, ones))
    shifted = [(s - offset, e - offset) for s, e in us]
    for (s, e), (h0, h1) in zip(shifted, ones):
        if s < h0 - SLACK_US or e > h1 + SLACK_US:
            return None
    return shifted


def _calls(res, steps, pattern) -> float:
    """Runtime calls named by ``pattern`` that start inside ``steps``, per
    step."""
    starts = sorted(s for n, s, _ in res.trace.host_ops if pattern.match(n))
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in steps)
    return n / len(steps)


def per_step(res) -> Optional[Dict[str, float]]:
    """Per traced step: the host ms of ``prep``, ``forward``, ``backward``,
    ``optim``, ``sync_wait`` and the whole ``step``, and the ``launches``
    and ``syncs`` inside it; None without a trace, without the program's
    records, or where its steps do not lie inside the harness's. The
    traced steps are the store's newest ``train.step`` records, one per
    ``train_one`` span (a process may hold earlier runs' records)."""
    recs = records() if res.trace is not None else None
    if not recs:
        return None
    n = sum(1 for x in res.trace.spans if x[0] == "train_one")
    idx = [i for i, r in enumerate(recs) if r.name == STEP and r.end_ns is not None][-n:]
    steps = aligned_steps(res, [recs[i] for i in idx]) if n else None
    if steps is None:
        return None
    out = {k: v / n for k, v in _parts_ms(recs, set(idx)).items()}
    out["step"] = sum((recs[i].end_ns - recs[i].start_ns) * 1e-6 for i in idx) / n
    out["launches"] = _calls(res, steps, LAUNCH)
    out["syncs"] = _calls(res, steps, SYNC)
    return out
