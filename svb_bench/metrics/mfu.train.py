"""A training step's least time on the card (``flops.hifigan_step_flops``
and kin: forward and backward of every update, the cluster's forward at
the bf16 peak, the rest at the float32 peak; the flagship's rows counted
at their items' own frames, so collation padding shows as lost share) over
the measured step time of the window, in %."""


def read(res):
    least, step_s = res.record.get("step_least_s"), res.record.get("step_s")
    return 100.0 * least / step_s if least and step_s else None
