"""JAX (flax) params -> the port's ``state_dict``: the exact inverse of
``convert_svbvae_mle_sd``, ``convert_hifigan`` and ``convert_ge2e`` in
``neuralsvb_tpu/convert/torch2jax.py``, the SVB VAE's other variants (which
the JAX package has no converter for), and the maps of the mel
discriminator and of the vocoder's multi-period and multi-scale ones.

The functions take nested dicts of numpy arrays (no JAX needed) and
return ``{name: torch.Tensor}`` under the reference parameter names, ready
for ``load_state_dict``. Layout rules:

- conv ``[k, in, out]`` -> ``[out, in, k]`` (grouped: ``[k, in/g, out]`` ->
  ``[out, in/g, k]``); 2-D conv ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``
- ConvTranspose (``transpose_kernel=True``) ``[k, out, in]`` -> ``[in, out, k]``
- dense ``[in, out]`` -> ``[out, in]``
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias`` +
  ``running_mean``/``running_var`` (``num_batches_tracked`` = 0)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]


class _SD(dict):
    def put(self, name: str, arr) -> None:
        self[name] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    def conv(self, prefix: str, p: Tree) -> None:
        """flax Conv kernel [k, in, out] -> torch [out, in, k]."""
        self.put(f"{prefix}.weight", np.asarray(p["kernel"]).transpose(2, 1, 0))
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def conv2d(self, prefix: str, p: Tree) -> None:
        """flax 2-D Conv kernel [kh, kw, in, out] -> torch [out, in, kh, kw]."""
        self.put(f"{prefix}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        self.put(f"{prefix}.bias", p["bias"])

    def convt(self, prefix: str, p: Tree) -> None:
        """flax ConvTranspose kernel [k, out, in] -> torch [in, out, k]."""
        self.conv(prefix, p)

    def dense(self, prefix: str, p: Tree) -> None:
        self.put(f"{prefix}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def norm(self, prefix: str, p: Tree) -> None:
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def bn(self, prefix: str, p: Tree, s: Tree) -> None:
        """Our BatchNorm1d wrapper keeps its flax BatchNorm as BatchNorm_0."""
        self.norm(prefix, p["BatchNorm_0"])
        self.put(f"{prefix}.running_mean", s["BatchNorm_0"]["mean"])
        self.put(f"{prefix}.running_var", s["BatchNorm_0"]["var"])
        self[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _wn(sd: _SD, prefix: str, p: Tree) -> None:
    if "cond_layer" in p:
        sd.conv(f"{prefix}.cond_layer", p["cond_layer"])
    n = sum(1 for k in p if k.startswith("in_layer_"))
    for i in range(n):
        sd.conv(f"{prefix}.in_layers.{i}", p[f"in_layer_{i}"])
        sd.conv(f"{prefix}.res_skip_layers.{i}", p[f"res_skip_{i}"])


def _conformer(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    n = sum(1 for k in p if k.startswith("layer_"))
    for i in range(n):
        lp, base = p[f"layer_{i}"], f"{prefix}.encoder_layers.{i}"
        for jax_name, torch_name in (("ff_macaron", "feed_forward_macaron"),
                                     ("ff", "feed_forward")):
            sd.conv(f"{base}.{torch_name}.w_1", lp[jax_name]["Conv_0"])
            sd.conv(f"{base}.{torch_name}.w_2", lp[jax_name]["Conv_1"])
        a = lp["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            sd.dense(f"{base}.self_attn.{name}", a[name])
        sd.put(f"{base}.self_attn.pos_bias_u", a["pos_bias_u"])
        sd.put(f"{base}.self_attn.pos_bias_v", a["pos_bias_v"])
        cp = lp["conv_module"]
        sd.conv(f"{base}.conv_module.pointwise_conv1", cp["Conv_0"])
        sd.conv(f"{base}.conv_module.depthwise_conv", cp["Conv_1"])
        sd.conv(f"{base}.conv_module.pointwise_conv2", cp["Conv_2"])
        sd.bn(f"{base}.conv_module.norm", cp["BatchNorm1d_0"],
              s[f"layer_{i}"]["conv_module"]["BatchNorm1d_0"])
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff",
                     "norm_final"):
            sd.norm(f"{base}.{name}", lp[name])
    if "last_norm" in p:
        sd.norm(f"{prefix}.layer_norm", p["last_norm"])
    elif "last_proj" in p:
        sd.dense(f"{prefix}.layer_norm", p["last_proj"])


def _vcasr(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    pn, ps = p["mel_prenet"], s["mel_prenet"]
    n = sum(1 for k in pn if k.startswith("Conv_"))
    for i in range(n):
        sd.conv(f"{prefix}.mel_prenet.layers.{i}.0", pn[f"Conv_{i}"])
        sd.bn(f"{prefix}.mel_prenet.layers.{i}.2", pn[f"BatchNorm1d_{i}"],
              ps[f"BatchNorm1d_{i}"])
    sd.dense(f"{prefix}.mel_prenet.out_proj", pn["Dense_0"])
    _conformer(sd, f"{prefix}.content_encoder", p["content_encoder"],
               s["content_encoder"])


def _conv_stacks(sd: _SD, prefix: str, p: Tree) -> None:
    sd.dense(f"{prefix}.in_proj", p["Dense_0"])
    n = sum(1 for k in p if k.startswith("ConvBlock_"))
    for i in range(n):
        blk = p[f"ConvBlock_{i}"]
        sd.conv(f"{prefix}.conv.{i}.conv.conv", blk["ConvNorm_0"]["Conv_0"])
        sd.norm(f"{prefix}.conv.{i}.norm", blk["GroupNorm_0"])
    sd.dense(f"{prefix}.out_proj", p["Dense_1"])


def _fvae(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    """``FVAE``, global (with the encoder's poolings) or frame-level."""
    sd.conv(f"{prefix}.g_pre_net.0", p["g_pre_0"])
    enc, dec = p["encoder"], p["decoder"]
    sd.conv(f"{prefix}.encoder.pre_net.0", enc["pre_0"])
    _wn(sd, f"{prefix}.encoder.wn", enc["wn"])
    sd.conv(f"{prefix}.encoder.out_proj", enc["out_proj"])
    sd.convt(f"{prefix}.decoder.pre_net.0", dec["pre_0"])
    _wn(sd, f"{prefix}.decoder.wn", dec["wn"])
    sd.conv(f"{prefix}.decoder.out_proj", dec["out_proj"])
    if "pool_0" not in enc:
        return
    for i, ci in enumerate((0, 3, 6)):
        sd.conv(f"{prefix}.encoder.poolings.{ci}", enc[f"pool_{i}"])
    for i, bi in enumerate((2, 5)):
        sd.bn(f"{prefix}.encoder.poolings.{bi}", enc[f"pool_bn_{i}"],
              s["encoder"][f"pool_bn_{i}"])


def _latent_map(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    """``LatentMap`` and ``GlobalLatentMap`` (the same layout)."""
    for i, ci in enumerate((0, 3, 6)):
        sd.conv(f"{prefix}.convs.{ci}", p[f"conv_{i}"])
    for i, bi in enumerate((1, 4)):
        sd.bn(f"{prefix}.convs.{bi}", p[f"bn_{i}"], s[f"bn_{i}"])
    sd.conv(f"{prefix}.spk_proj.0", p["spk_proj_0"])
    sd.conv(f"{prefix}.spk_proj.2", p["spk_proj_1"])


def svbvae_from_jax(params: Tree, batch_stats: Tree,
                    variant: str = "mle") -> Dict[str, torch.Tensor]:
    """``SVBVAE(variant=...)`` params + batch_stats -> port state_dict, for
    all five variants. The seg variant's attention modules have no known
    reference names: the port names them after their JAX module paths
    (``k_mel_encoder_0``, ``k_mel_encoder_bn``, ``k_mel_encoder_1``,
    ``seg_ref_attn.{q,k,v,out}_proj``)."""
    sd = _SD()
    sd.put("pitch_embed.weight", params["pitch_embed"]["Embed_0"]["embedding"])
    _conv_stacks(sd, "pitch_encoder", params["pitch_encoder"])
    _vcasr(sd, "vc_asr", params["vc_asr"], batch_stats["vc_asr"])
    up, us = params["upsample_layer"], batch_stats["upsample_layer"]
    sd.conv("upsample_layer.0.1", up["conv_0"])
    sd.bn("upsample_layer.0.3", up["bn_0"], us["bn_0"])
    sd.conv("upsample_layer.1", up["conv_out"])
    sd.dense("spk_embed_proj", params["spk_embed_proj"])
    sd.dense("encoded_embed_proj", params["encoded_embed_proj"])
    _fvae(sd, "vae_model", params["vae_model"], batch_stats.get("vae_model", {}))
    maps = (("z_mapping_function",) if variant in ("mle", "tech_mle", "seg_tech_mle")
            else ("m_mapping_function", "logs_mapping_function"))
    for name in maps:
        _latent_map(sd, name, params[name], batch_stats[name])
    if variant == "seg_tech_mle":
        sd.conv("k_mel_encoder_0", params["k_mel_encoder_0"])
        sd.bn("k_mel_encoder_bn", params["k_mel_encoder_bn"], batch_stats["k_mel_encoder_bn"])
        sd.conv("k_mel_encoder_1", params["k_mel_encoder_1"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"seg_ref_attn.{name}", params["seg_ref_attn"][name])
    return dict(sd)


def svbvae_mle_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """``SVBVAE(variant="mle")`` params + batch_stats -> port state_dict."""
    return svbvae_from_jax(params, batch_stats, "mle")


def disc_from_jax(params: Tree, batch_stats: Tree,
                  freq_length: int = 80) -> Dict[str, torch.Tensor]:
    """Flax ``Discriminator`` (unconditional) params + batch_stats -> the
    port's ``mel_disc`` state_dict. Conv2d kernels [kh, kw, in, out] ->
    [out, in, kh, kw]; the head's rows go from the JAX flatten order of the
    NHWC conv output (t, f, c) to torch's NCHW order (c, t, f)."""
    sd = _SD()
    p = params["discriminator"]
    s = (batch_stats or {}).get("discriminator", {})
    n = sum(1 for k in p if k.startswith("disc_"))
    for i in range(n):
        dp, base = p[f"disc_{i}"], f"discriminator.discriminators.{i}"
        for j in range(3):
            conv = dp[f"conv_{j}"]
            sd.put(f"{base}.model.{j}.0.weight",
                   np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
            sd.put(f"{base}.model.{j}.0.bias", conv["bias"])
            if f"norm_{j}" in dp:  # disc_norm 'bn'
                st = s[f"disc_{i}"][f"norm_{j}"]
                sd.norm(f"{base}.model.{j}.3", dp[f"norm_{j}"])
                sd.put(f"{base}.model.{j}.3.running_mean", st["mean"])
                sd.put(f"{base}.model.{j}.3.running_var", st["var"])
                sd[f"{base}.model.{j}.3.num_batches_tracked"] = torch.tensor(0)
        C = np.asarray(dp["conv_2"]["bias"]).shape[0]
        k = np.asarray(dp["adv_layer"]["kernel"])[:, 0]
        f = freq_length
        for _ in range(3):  # three stride-2 convs with padding 1
            f = (f + 1) // 2
        t = k.shape[0] // (C * f)
        sd.put(f"{base}.adv_layer.weight",
               k.reshape(t, f, C).transpose(2, 0, 1).reshape(1, -1))
        sd.put(f"{base}.adv_layer.bias", dp["adv_layer"]["bias"])
    return dict(sd)


def ge2e_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``VoiceEncoder`` params (layers ``OptimizedLSTMCell_{i}``, the
    tree the flax model has) -> Resemblyzer-named state_dict; per layer the
    inverse of ``lstm_layer_to_flax``. Flax keeps one Dense per gate (i, f,
    g, o, torch's order), with the bias only on the hidden projection, so it
    all goes to ``bias_ih`` and ``bias_hh`` is zero."""
    sd = _SD()
    gates = ("i", "f", "g", "o")
    n = sum(1 for k in params if k.startswith("OptimizedLSTMCell_"))
    for layer in range(n):
        cell = params[f"OptimizedLSTMCell_{layer}"]
        sd.put(f"lstm.weight_ih_l{layer}", np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in gates]))
        sd.put(f"lstm.weight_hh_l{layer}", np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in gates]))
        bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
        sd.put(f"lstm.bias_ih_l{layer}", bias)
        sd.put(f"lstm.bias_hh_l{layer}", np.zeros_like(bias))
    sd.dense("linear", params["linear"])
    return dict(sd)


def hifigan_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``HifiGanGenerator`` params -> port state_dict."""
    sd = _SD()
    sd.conv("conv_pre", params["conv_pre"])
    sd.conv("conv_post", params["conv_post"])
    if "m_source" in params:
        sd.dense("m_source.l_linear", params["m_source"]["l_linear"])
    n_up = sum(1 for k in params if k.startswith("up_"))
    n_k = sum(1 for k in params if k.startswith("resblock_0_"))
    for i in range(n_up):
        sd.convt(f"ups.{i}", params[f"up_{i}"])
        if f"noise_conv_{i}" in params:
            sd.conv(f"noise_convs.{i}", params[f"noise_conv_{i}"])
        for j in range(n_k):
            blk, r = params[f"resblock_{i}_{j}"], i * n_k + j
            if "conv1_0" in blk:
                n = sum(1 for k in blk if k.startswith("conv1_"))
                for c in range(n):
                    sd.conv(f"resblocks.{r}.convs1.{c}", blk[f"conv1_{c}"])
                    sd.conv(f"resblocks.{r}.convs2.{c}", blk[f"conv2_{c}"])
            else:
                n = sum(1 for k in blk if k.startswith("conv_"))
                for c in range(n):
                    sd.conv(f"resblocks.{r}.convs.{c}", blk[f"conv_{c}"])
    return dict(sd)


def mpd_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``MultiPeriodDiscriminator`` params (``disc_p{period}``, in period
    order) -> port state_dict."""
    sd = _SD()
    for i, name in enumerate(sorted(params, key=lambda k: int(k[len("disc_p"):]))):
        dp = params[name]
        for j in range(sum(1 for k in dp if k.startswith("conv_") and k != "conv_post")):
            sd.conv2d(f"discriminators.{i}.convs.{j}", dp[f"conv_{j}"])
        sd.conv2d(f"discriminators.{i}.conv_post", dp["conv_post"])
    return dict(sd)


def msd_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``MultiScaleDiscriminator`` params (``disc_s{i}``) -> port state_dict."""
    sd = _SD()
    for i in range(len(params)):
        dp = params[f"disc_s{i}"]
        for j in range(sum(1 for k in dp if k.startswith("conv_") and k != "conv_post")):
            sd.conv(f"discriminators.{i}.convs.{j}", dp[f"conv_{j}"])
        sd.conv(f"discriminators.{i}.conv_post", dp["conv_post"])
    return dict(sd)
