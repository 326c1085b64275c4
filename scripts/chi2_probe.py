#!/usr/bin/env python3
"""Device-time probe of the port's chi-square DTW cost kernel on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card and nvcc::

    python3 scripts/chi2_probe.py [--baseline OLD_chi2_dist.cu ...] [--out DIR]

- builds ``neuralsvb_torch/csrc/chi2_dist.cu`` as shipped, each earlier
  source given with ``--baseline`` (for example the parent commit's,
  unpacked with ``git archive``), and a diagnostic variant whose division
  is ``__fdividef`` (not a kernel of the port: it shows what the exact
  division costs);
- writes each library's SASS (``cuobjdump -sass``) to DIR and counts its
  instructions by opcode, with the ptxas lines;
- checks each variant against the plain version (max|d|, and max|d| /
  max(1, |ref|)) and against the shipped kernel (bit for bit), on every
  input kind at four shapes;
- sweeps the kernel's branch-free division ``div_rn`` against ``/`` over
  random operand pairs of an in-range chunk (values in {0} U [2^-24, 2^24],
  near-equal pairs included) and counts the results that differ in any bit;
- times each variant at (S, T) = (2400, 2400), M = 48 on every input kind:
  N launches enqueued between two CUDA events, over N, in turns (variants
  in order, then in reverse), so only device time is counted.

Prints one JSON line per result and writes them all to DIR/probe.json.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neuralsvb_torch.data.synthetic import chi2_inputs  # noqa: E402
from neuralsvb_torch.utils.profiling import device_ms, fast_loop_per_term, sass  # noqa: E402

DIV_LINE = "acc[i][j] += FAST ? div_rn(n, den) : n / den;"
FDIVIDEF_LINE = "acc[i][j] += __fdividef(n, den);"
S = T = 2400
M = 48
SMI_QUERY = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"

# div_rn against `/` on operand pairs built as the kernel builds them
DIV_CHECK = r"""
#include "{source}"

namespace {{
__device__ unsigned long long mix(unsigned long long x) {{
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  return x ^ (x >> 33);
}}
// {{0}} with probability 1/8, else 2^e * (1 + mantissa), e uniform in [-24, 23]
__device__ float in_range(unsigned long long h) {{
  if ((h & 7) == 0) return 0.f;
  const unsigned e = 127 - 24 + (unsigned)((h >> 3) % 48);
  return __uint_as_float((e << 23) | (unsigned)((h >> 9) & 0x7fffff));
}}
__global__ void div_check(unsigned long long n, unsigned long long seed,
                          unsigned long long* mismatches, unsigned long long* zero_num) {{
  unsigned long long bad = 0, zeros = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {{
    const unsigned long long h = mix(seed ^ mix(i));
    const float a = in_range(h);
    float b;
    switch ((h >> 40) & 3) {{
      case 0: {{  // a few ulps from a (tiny differences), still in range
        const int delta = (int)((h >> 42) & 15) - 8;
        b = a == 0.f ? 0.f : __uint_as_float(__float_as_uint(a) + delta);
        if (!(b >= 0x1p-24f && b <= 0x1p24f)) b = a;
        break;
      }}
      case 1: b = a; break;
      default: b = in_range(mix(h));
    }}
    const float d = b - a;
    const float num = 0.5f * (d * d), den = b + a + 1e-8f;
    zeros += num == 0.f;
    bad += __float_as_uint(div_rn(num, den)) != __float_as_uint(num / den);
  }}
  atomicAdd(mismatches, bad);
  atomicAdd(zero_num, zeros);
}}
}}  // namespace

extern "C" int probe_div_check(unsigned long long n, unsigned long long seed, void* counts) {{
  unsigned long long* c = (unsigned long long*)counts;
  div_check<<<132 * 8, 256>>>(n, seed, c, c + 1);
  return (int)cudaGetLastError();
}}
"""


def emit(out, kind, **kw):
    row = {"kind": kind, **kw}
    print(json.dumps(row), flush=True)
    out.append(row)


def smi():
    return subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def libraries(baselines, work):
    """name -> SharedLibrary, not yet built; and the division check's library."""
    from neuralsvb_torch.ops import chi2
    from neuralsvb_torch.ops.shared_lib import NVCC, NVCC_FLAGS, SharedLibrary
    libs = {"shipped": chi2.LIBRARY}
    for i, path in enumerate(baselines):
        libs[f"baseline{i}"] = SharedLibrary(f"probe_baseline{i}", Path(path).resolve(), NVCC,
                                             NVCC_FLAGS, chi2._bind)
    src = chi2.SOURCE.read_text()
    if src.count(DIV_LINE) != 1:
        raise RuntimeError(f"{chi2.SOURCE}: the division line is not there once")
    work.mkdir(parents=True, exist_ok=True)
    path = work / "diag_fdividef.cu"
    path.write_text(src.replace(DIV_LINE, FDIVIDEF_LINE))
    libs["diag_fdividef"] = SharedLibrary("probe_diag_fdividef", path, NVCC, NVCC_FLAGS,
                                          chi2._bind)
    path = work / "div_check.cu"
    path.write_text(DIV_CHECK.format(source=chi2.SOURCE))

    def bind(lib):
        lib.probe_div_check.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                        ctypes.c_void_p]
        lib.probe_div_check.restype = ctypes.c_int

    return libs, SharedLibrary("probe_div_check", path, NVCC, NVCC_FLAGS, bind)


def sass_counts(lib_path, dump):
    text = sass(lib_path)
    dump.write_text(text)
    ops = collections.Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", text):
        ops[m.group(1)] += 1
    return dict(total=sum(ops.values()),
                fast_loop_per_term=fast_loop_per_term(text),
                **{k: ops[k] for k in (
        "MUFU", "FCHK", "FFMA", "FADD", "FMUL", "LDS", "LDGSTS", "STG", "BRA", "CALL",
        "BSSY", "BSYNC", "BAR", "FSETP", "FSEL", "ISETP")})


def inputs(device):
    """The smoke's three input kinds (``chi2_inputs``) at 2400 x 2400, and dense, equal and
    all-zero rows."""
    import numpy as np
    import torch
    (sh, th), (ra, rb), (oa, ob) = chi2_inputs(S, T, seed=0)
    rng = np.random.RandomState(7)
    da, db = rng.rand(S, M) + 0.05, rng.rand(T, M) + 0.05
    da /= da.sum(1, keepdims=True)
    db /= db.sum(1, keepdims=True)
    eq = np.full((S, M), 1.0 / M)
    kinds = {"hist": (sh, th), "rand_zero_rows": (ra, rb), "out_of_range": (oa, ob),
             "dense": (da, db), "equal": (eq, np.full((T, M), 1.0 / M)),
             "zeros": (np.zeros((S, M)), np.zeros((T, M)))}
    return {k: tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in v)
            for k, v in kinds.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="an earlier chi2_dist.cu to time beside the shipped one (repeatable)")
    ap.add_argument("--out", default=str(REPO / "build" / "chi2_probe" / "results"))
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--div-pairs", type=int, default=1 << 32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chi2_probe.py needs a CUDA card")
    from neuralsvb_torch.ops import chi2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    emit(rows, "environment", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi())

    libs, div_lib = libraries(args.baseline, REPO / "build" / "chi2_probe")
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        for fut in [pool.submit(lib.get) for lib in [*libs.values(), div_lib]]:
            fut.result()
    for name, lib in libs.items():
        emit(rows, "build", name=name, source=str(lib.source),
             ptxas=[ln.strip() for ln in lib.build_log.splitlines()
                    if "registers" in ln or "spill" in ln],
             sass=sass_counts(lib.path, out_dir / f"{name}.sass"))

    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = div_lib.get().probe_div_check(args.div_pairs, 12345, counts.data_ptr())
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"div_check: CUDA error {err}")
    emit(rows, "div_check", pairs=args.div_pairs, mismatches=int(counts[0]),
         zero_numerators=int(counts[1]))

    data = inputs("cuda")
    outs = {}
    for name, lib in libs.items():
        fn = lib.get().nsvb_chi2_dist
        for kind, (a, b) in data.items():
            for (s, t) in ((S, T), (1037, 1301), (130, 70), (1, 1)):
                aa, bb = a[:s].contiguous(), b[:t].contiguous()
                o = torch.empty(s, t, device="cuda")
                err = fn(aa.data_ptr(), bb.data_ptr(), o.data_ptr(), s, t, M,
                         torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err} at {(s, t)}")
                outs[name, kind, s, t] = o
    for (name, kind, s, t), o in outs.items():
        a, b = (x.contiguous() for x in (data[kind][0][:s], data[kind][1][:t]))
        ref = chi2.chi2_dist_plain(a, b)
        d = (o - ref).abs()
        emit(rows, "check", name=name, input=kind, S=s, T=t, max_abs_err=float(d.max()),
             max_rel_err=float((d / ref.abs().clamp_min(1.0)).max()),
             equal_to_shipped=bool(torch.equal(o, outs["shipped", kind, s, t])))
    del outs

    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(S, T, device="cuda")
    n = args.launches

    times = collections.defaultdict(list)
    emit(rows, "clocks_before", nvidia_smi=smi())
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            fn = libs[name].get().nsvb_chi2_dist
            for kind, (a, b) in data.items():
                call = (a.data_ptr(), b.data_ptr(), out.data_ptr(), S, T, M, stream)
                times[name, kind].append(device_ms(lambda: fn(*call), n))
    emit(rows, "clocks_after", nvidia_smi=smi())
    terms = S * T * M
    for (name, kind), ts in times.items():
        emit(rows, "device_time", name=name, input=kind, S=S, T=T, M=M, launches=n,
             ms=ts, ms_min=min(ts), gterms_per_s=terms / min(ts) / 1e6)
    (out_dir / "probe.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
