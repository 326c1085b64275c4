"""Device time of the SVB model's forward (CUDA events around
``SVBVAEMleTask.forward``, summed) per second of a2p audio served."""


def read(res):
    ms, audio = res.record.get("forward_ms"), res.record.get("events_audio_s")
    return sum(ms) / sum(audio) if ms and sum(audio) > 0 else None
