"""``flops.py`` against the counts and shape formulas it stands for."""


import torch
import torch.nn as nn

from svb_bench import flops

GEN = dict(upsample_rates=[8, 8, 2], upsample_kernel_sizes=[16, 16, 4],
           upsample_initial_channel=512, resblock="1", resblock_kernel_sizes=[3, 7, 11],
           resblock_dilation_sizes=[[1, 3, 5]] * 3, use_pitch_embed=True,
           audio_sample_rate=22050, num_mels=80)
SVB = dict(hidden_size=256, num_mel_bins=80, latent_size=128, fvae_hidden=192,
           fvae_kernel=5, fvae_enc_layers=8, fvae_dec_layers=4, frames_multiple=4,
           mel_strides=[2, 1, 1], asr_enc_layers=2, asr_last_norm=False)


def test_cluster_at_the_2048_bucket():
    """PERF.md's count (PR 13: ``op_flops`` of the plain cluster equal to
    ``cluster_work``): three stages of 18 convolutions."""
    stages = flops.stage_shapes(2048, GEN["upsample_rates"], GEN["upsample_initial_channel"])
    assert stages == ((256, 16384), (128, 131072), (64, 262144))
    assert flops.cluster_flops(1, stages, [3, 7, 11], [[1, 3, 5]] * 3) == 1_082_331_758_592


def test_generator_count_is_cluster_plus_linear_rest():
    """``generator_flops`` takes every layer but the cluster as linear in
    the frames: a count on meta tensors at another length agrees."""
    g = flops._generator(flops._key(GEN))
    for t in (1000, 4096):
        with torch.no_grad():
            total = flops.count(g, flops.meta((1, t, 80)), flops.meta((1, t)), zero_noise=True)
        assert sum(flops.generator_flops(GEN, 1, t)) == total
    c, _ = flops.generator_flops(GEN, 1, 1000)
    assert c == flops.cluster_flops(1, flops.stage_shapes(1000, [8, 8, 2], 512), [3, 7, 11],
                                    [[1, 3, 5]] * 3)


def test_conv_transpose_formula():
    """A transposed convolution counts 2 x C_in x C_out x k x T_in."""
    up = nn.ConvTranspose1d(512, 256, 16, 8, padding=4, device="meta")
    assert flops.count(up, flops.meta((1, 512, 100))) == 2 * 512 * 256 * 16 * 100


def test_svb_count_on_meta_equals_a_real_count_and_the_attention_formula():
    """The SVB forward counted on meta tensors equals the count of a real
    CPU run on seeded inputs (nothing is skipped for want of data), and its
    batched products are the conformer's attention: per layer and side
    three (content scores, position scores, values), 2 x T^2 x H each, at
    T = frames / 2."""
    from torch.utils.flop_counter import FlopCounterMode
    from svb_bench import synth
    from svb_bench.reference.svb_vae import SVBVAE
    kw = dict(SVB, hidden_size=64, latent_size=16, fvae_hidden=32, fvae_enc_layers=2,
              fvae_dec_layers=2, asr_enc_layers=2)
    r = synth.a2p_deck({"deck": 1, "prof_seconds": [1.0, 1.0], "amateur_factor": [1.1, 1.1],
                        "max_frames": 5000}, seed=3)[0]
    torch.manual_seed(0)
    model = SVBVAE(**kw).eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.as_tensor(r["mels"]), torch.as_tensor(r["prof_mels"]),
              torch.as_tensor(r["pitch"]), torch.as_tensor(r["prof_pitch"]),
              torch.as_tensor(r["multi_spk_emb"][:, 0]), torch.as_tensor(r["a2p_f0_alignment"]),
              zero_noise=True)
    assert flops.svb_forward_flops(kw, r["t_a"], r["t_p"]) == fc.get_total_flops()
    bmm = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "bmm" in str(k))
    assert bmm == sum(kw["asr_enc_layers"] * 3 * 2 * (t // 2) ** 2 * kw["hidden_size"]
                      for t in (r["t_a"], r["t_p"]))


def test_hifigan_step_counts_both_updates():
    f = flops.hifigan_step_flops(GEN, 16, 8192)
    assert f["bf16"] == flops.cluster_flops(16, flops.stage_shapes(64, [8, 8, 2], 512),
                                            [3, 7, 11], [[1, 3, 5]] * 3)
    c, rest = flops.generator_flops(GEN, 16, 64)
    # the generator's forward and backward alone are 3 x its forward
    assert f["f32"] > c * 2 + rest * 3
