"""The AMP activations' least time at the traced steps' shapes
(``flops_bigvgan.amp_least_s``: bytes at the HBM peak or operations at the
float32 peak, the larger, forward and backward) over the summed device
time of their kernels (``amp_activation`` in the name) in the traced
window, in %."""

# the kernels of the program's csrc/amp_activation.cu
AMP_KERNELS = ("amp_activation",)


def read(res):
    if res.trace is None or "amp_least_s" not in res.record:
        return None
    t = res.trace.kernel_seconds(AMP_KERNELS)
    return 100.0 * res.record["amp_least_s"] / t if t > 0 else None
