"""The ResBlock cluster's least time at the bucketed shapes it was given
(FLOPs at the bf16 peak, or bytes at the HBM peak, the larger) over the
summed device time of its kernels in the traced window, in %."""

from svb_bench.trace import CLUSTER_KERNELS


def read(res):
    if res.trace is None or "cluster_least_s" not in res.record:
        return None
    t = res.trace.kernel_seconds(CLUSTER_KERNELS)
    return 100.0 * res.record["cluster_least_s"] / t if t > 0 else None
