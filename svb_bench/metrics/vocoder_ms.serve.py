"""Device time of the vocoder (CUDA events around ``HifiGAN.spec2wav``,
summed) per second of a2p audio served."""


def read(res):
    ms, audio = res.record.get("spec2wav_ms"), res.record.get("events_audio_s")
    return sum(ms) / sum(audio) if ms and sum(audio) > 0 else None
