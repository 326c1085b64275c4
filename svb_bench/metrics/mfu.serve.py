"""The requests' least time on the card (``flops.request_least_s`` at each
request's own frames: the cluster at the bf16 peak, the rest at the
float32 peak) over their measured latency, summed over the window, in %."""


def read(res):
    least, lat = res.record.get("least_s"), res.record.get("latency_s")
    if not least or len(least) != len(lat):
        return None
    return 100.0 * sum(least) / sum(lat)
