"""Device time of the AMP activations' kernels (``amp_activation`` in the
name: forward, backward and the parameters' reduction) per traced step, in
ms."""

# the kernels of the program's csrc/amp_activation.cu
AMP_KERNELS = ("amp_activation",)


def read(res):
    if res.trace is None:
        return None
    steps = sum(1 for name, _, _ in res.trace.spans if name == "train_one")
    t = res.trace.kernel_seconds(AMP_KERNELS)
    return 1e3 * t / steps if steps and t > 0 else None
