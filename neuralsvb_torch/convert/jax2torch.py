"""JAX (flax) params -> the port's ``state_dict``: the exact inverse of
``convert_svbvae_mle_sd``, ``convert_hifigan``, ``convert_ge2e`` and
``convert_vcasr`` in ``neuralsvb_tpu/convert/torch2jax.py``, of
``convert_pwg`` and ``convert_melgan_generator``, the SVB VAE's other
variants, the PPG models (``VCPPG``, ``SVBPPG``, ``ParaSVBPPG``),
``FastSpeech2`` and ``PitchExtractor`` (the JAX package has no converter for
these), and the maps of the discriminators:
the mel discriminator, the vocoders' multi-period and multi-scale ones,
PWG's and MelGAN's.

The functions take nested dicts of numpy arrays (no JAX needed; what
``convert/msgpack_ckpt.py`` decodes from a JAX checkpoint) and
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


def _np(x) -> np.ndarray:
    """A leaf as numpy; a ``torch.bfloat16`` leaf (how ``msgpack_ckpt``
    decodes flax's bfloat16 arrays) widens to float32, which is exact."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x)


class _SD(dict):
    def put(self, name: str, arr) -> None:
        self[name] = torch.from_numpy(np.ascontiguousarray(_np(arr)))

    def conv(self, prefix: str, p: Tree) -> None:
        """flax Conv kernel [k, in, out] -> torch [out, in, k]."""
        self.put(f"{prefix}.weight", _np(p["kernel"]).transpose(2, 1, 0))
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def conv2d(self, prefix: str, p: Tree) -> None:
        """flax 2-D Conv kernel [kh, kw, in, out] -> torch [out, in, kh, kw]."""
        self.put(f"{prefix}.weight", _np(p["kernel"]).transpose(3, 2, 0, 1))
        self.put(f"{prefix}.bias", p["bias"])

    def convt(self, prefix: str, p: Tree) -> None:
        """flax ConvTranspose kernel [k, out, in] -> torch [in, out, k]."""
        self.conv(prefix, p)

    def dense(self, prefix: str, p: Tree) -> None:
        self.put(f"{prefix}.weight", _np(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def norm(self, prefix: str, p: Tree) -> None:
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def bn(self, prefix: str, p: Tree, s: Tree) -> None:
        """Our BatchNorm1d wrapper keeps its flax BatchNorm as BatchNorm_0;
        ``s`` None: the scale and bias only (no running statistics)."""
        self.norm(prefix, p["BatchNorm_0"])
        if s is None:
            return
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
              None if s is None else s[f"layer_{i}"]["conv_module"]["BatchNorm1d_0"])
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff",
                     "norm_final"):
            sd.norm(f"{base}.{name}", lp[name])
    if "last_norm" in p:
        sd.norm(f"{prefix}.layer_norm", p["last_norm"])
    elif "last_proj" in p:
        sd.dense(f"{prefix}.layer_norm", p["last_proj"])


def _mha(sd: _SD, prefix: str, p: Tree) -> None:
    """Separate q/k/v/out Dense -> the fused ``in_proj_weight`` [3C, C] of
    the reference (the inverse of torch2jax's ``_mha_split``)."""
    sd.put(f"{prefix}.in_proj_weight", np.concatenate(
        [_np(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")]))
    sd.dense(f"{prefix}.out_proj", p["out_proj"])


def _asr_decoder(sd: _SD, prefix: str, p: Tree) -> None:
    n = sum(1 for k in p if k.startswith("layer_") and k[len("layer_"):].isdigit())
    for i in range(n):
        lp, base = p[f"layer_{i}"], f"{prefix}.layers.{i}.op"
        for j in range(3):
            sd.norm(f"{base}.layer_norm{j + 1}", lp[f"LayerNorm_{j}"])
        _mha(sd, f"{base}.self_attn", lp["MultiheadAttention_0"])
        _mha(sd, f"{base}.encoder_attn", lp["MultiheadAttention_1"])
        sd.conv(f"{base}.ffn.ffn_1.1", lp["TransformerFFNLayer_0"]["Conv_0"])
        sd.dense(f"{base}.ffn.ffn_2", lp["TransformerFFNLayer_0"]["Dense_0"])
    sd.norm(f"{prefix}.layer_norm", p["layer_norm"])
    sd.dense(f"{prefix}.project_out_dim", p["project_out"])


def _vcasr(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    pn = p["mel_prenet"]
    n = sum(1 for k in pn if k.startswith("Conv_"))
    for i in range(n):
        sd.conv(f"{prefix}.mel_prenet.layers.{i}.0", pn[f"Conv_{i}"])
        sd.bn(f"{prefix}.mel_prenet.layers.{i}.2", pn[f"BatchNorm1d_{i}"],
              None if s is None else s["mel_prenet"][f"BatchNorm1d_{i}"])
    sd.dense(f"{prefix}.mel_prenet.out_proj", pn["Dense_0"])
    if "Dense_0" in p["content_encoder"]:  # asr_enc_type: conv
        _conv_stacks(sd, f"{prefix}.content_encoder", p["content_encoder"])
    else:
        _conformer(sd, f"{prefix}.content_encoder", p["content_encoder"],
                   None if s is None else s["content_encoder"])
    if "asr_decoder" in p:
        sd.put(f"{prefix}.token_embed.weight", p["token_embed"]["Embed_0"]["embedding"])
        _asr_decoder(sd, f"{prefix}.asr_decoder", p["asr_decoder"])


def vcasr_from_jax(params: Tree, batch_stats: Tree = None) -> Dict[str, torch.Tensor]:
    """``VCASR`` params (+ batch_stats) -> the port's ``vc_asr`` state_dict
    (without the ``vc_asr.`` prefix); without batch_stats it holds no
    BatchNorm running statistics. A tree with the transformer decoder gives
    its keys too (``token_embed``, ``asr_decoder.layers.{i}.op...``, the
    reference's names)."""
    sd = _SD()
    _vcasr(sd, "vc_asr", params, batch_stats)
    return {k[len("vc_asr."):]: v for k, v in sd.items()}


def _conv_stacks(sd: _SD, prefix: str, p: Tree, s: Tree = None) -> None:
    """``ConvStacks`` of any norm: ``gn`` (GroupNorm_0), ``bn``
    (BatchNorm1d_0, with its statistics from ``s``), ``in`` (the block's
    in_scale/in_bias) or ``none``; each is ``conv.{i}.norm`` in the port."""
    sd.dense(f"{prefix}.in_proj", p["Dense_0"])
    n = sum(1 for k in p if k.startswith("ConvBlock_"))
    for i in range(n):
        blk, base = p[f"ConvBlock_{i}"], f"{prefix}.conv.{i}"
        sd.conv(f"{base}.conv.conv", blk["ConvNorm_0"]["Conv_0"])
        if "GroupNorm_0" in blk:
            sd.norm(f"{base}.norm", blk["GroupNorm_0"])
        elif "BatchNorm1d_0" in blk:
            sd.bn(f"{base}.norm", blk["BatchNorm1d_0"],
                  None if s is None else s[f"ConvBlock_{i}"]["BatchNorm1d_0"])
        elif "in_scale" in blk:
            sd.put(f"{base}.norm.weight", blk["in_scale"])
            sd.put(f"{base}.norm.bias", blk["in_bias"])
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
    if "prior_flow" in p:  # use_prior_glow
        _glow(sd, f"{prefix}.prior_flow", p["prior_flow"])
    if "pool_0" not in enc:
        return
    for i, ci in enumerate((0, 3, 6)):
        sd.conv(f"{prefix}.encoder.poolings.{ci}", enc[f"pool_{i}"])
    for i, bi in enumerate((2, 5)):
        sd.bn(f"{prefix}.encoder.poolings.{bi}", enc[f"pool_bn_{i}"],
              s["encoder"][f"pool_bn_{i}"])


def _glow(sd: _SD, prefix: str, p: Tree) -> None:
    """``ResidualCouplingBlock``: ``flow_{i}`` -> ``flows.{2i}`` (the flips
    between them hold no weights)."""
    n = sum(1 for k in p if k.startswith("flow_"))
    for i in range(n):
        fp, base = p[f"flow_{i}"], f"{prefix}.flows.{2 * i}"
        sd.conv(f"{base}.pre", fp["pre"])
        _wn(sd, f"{base}.enc", fp["enc"])
        sd.conv(f"{base}.post", fp["post"])


def glow_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``ResidualCouplingBlock`` params -> the port's state_dict."""
    sd = _SD()
    _glow(sd, "b", params)
    return {k[2:]: v for k, v in sd.items()}


def tech_classifier_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """``TechClassifier`` params + batch_stats -> the port's state_dict."""
    sd = _SD()
    _latent_map(sd, "t", params, batch_stats)
    return {k[2:]: v for k, v in sd.items()}


def _latent_map(sd: _SD, prefix: str, p: Tree, s: Tree) -> None:
    """``LatentMap``, ``GlobalLatentMap`` and ``TechClassifier`` (the same
    layout)."""
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


def vcppg_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """``VCPPG``/``SVBPPG``/``ParaSVBPPG`` params + batch_stats (the JAX
    ``SVBParaTask`` generator tree) -> the port's state_dict."""
    sd = _SD()
    for name in ("pitch_embed", "energy_embed", "spk_embed", "tech_embed"):
        if name in params:
            sd.put(f"{name}.weight", params[name]["Embed_0"]["embedding"])
    _conv_stacks(sd, "pitch_encoder", params["pitch_encoder"])
    _vcasr(sd, "vc_asr", params["vc_asr"], batch_stats["vc_asr"])
    up, us = params["upsample_layer"], batch_stats["upsample_layer"]
    n = sum(1 for k in up if k.startswith("conv_") and k != "conv_out")
    for i in range(n):
        sd.conv(f"upsample_layer.{i}.1", up[f"conv_{i}"])
        sd.bn(f"upsample_layer.{i}.3", up[f"bn_{i}"], us[f"bn_{i}"])
    sd.conv(f"upsample_layer.{n}", up["conv_out"])
    if "ref_encoder" in params:  # ConvGlobalStacks: the ConvStacks layout
        _conv_stacks(sd, "ref_encoder", params["ref_encoder"])
    if "ref_attn_kv_encoder" in params:  # ref_attn
        _conv_stacks(sd, "ref_attn_kv_encoder", params["ref_attn_kv_encoder"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"ref_attn_mha.{name}", params["ref_attn_mha"][name])
    sd.dense("encoded_embed_proj", params["encoded_embed_proj"])
    if "blocks" in params["decoder"]:  # decoder_type: fft
        _fft_blocks(sd, "decoder.blocks", params["decoder"]["blocks"])
    else:
        _conv_stacks(sd, "decoder", params["decoder"])
    sd.dense("mel_out", params["mel_out"])
    return dict(sd)


def _fft_blocks(sd: _SD, prefix: str, p: Tree) -> None:
    """``FFTBlocks``: ``layer_{i}`` (``EncSALayer``) -> ``layers.{i}``."""
    n = sum(1 for k in p if k.startswith("layer_") and k[len("layer_"):].isdigit())
    for i in range(n):
        lp, base = p[f"layer_{i}"], f"{prefix}.layers.{i}"
        sd.norm(f"{base}.layer_norm1", lp["LayerNorm_0"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(f"{base}.self_attn.{name}", lp["MultiheadAttention_0"][name])
        sd.norm(f"{base}.layer_norm2", lp["LayerNorm_1"])
        sd.conv(f"{base}.ffn.ffn_1.1", lp["TransformerFFNLayer_0"]["Conv_0"])
        sd.dense(f"{base}.ffn.ffn_2", lp["TransformerFFNLayer_0"]["Dense_0"])
    sd.norm(f"{prefix}.last_norm", p["last_norm"])


def _predictor(sd: _SD, prefix: str, p: Tree) -> None:
    """A predictor's ``stack`` (``PredictorConvStack``)."""
    st = p["stack"]
    n = sum(1 for k in st if k.startswith("conv_"))
    for i in range(n):
        sd.conv(f"{prefix}.stack.conv.{i}", st[f"conv_{i}"])
        sd.norm(f"{prefix}.stack.ln.{i}", st[f"ln_{i}"])
    sd.dense(f"{prefix}.stack.linear", st["linear"])


def fs2_from_jax(params: Tree, batch_stats: Tree = None) -> Dict[str, torch.Tensor]:
    """``FastSpeech2`` params -> the port's state_dict, for either decoder,
    frame or CWT pitch, energy, and a speaker id or embedding projection.
    The model holds no BatchNorm, so ``batch_stats`` is empty (accepted for
    the loaders' uniform call)."""
    sd = _SD()
    enc = params["encoder"]
    sd.put("encoder.embed_tokens.weight", enc["embed_tokens"]["Embed_0"]["embedding"])
    _fft_blocks(sd, "encoder.blocks", enc["blocks"])
    spk = params.get("spk_embed_proj")
    if spk is not None and "Embed_0" in spk:
        sd.put("spk_embed_proj.weight", spk["Embed_0"]["embedding"])
    elif spk is not None:
        sd.dense("spk_embed_proj", spk)
    for name in ("dur_predictor", "pitch_predictor", "cwt_predictor", "energy_predictor"):
        if name in params:
            _predictor(sd, name, params[name])
    for name in ("cwt_in", "cwt_stats_0", "cwt_stats_1", "cwt_stats_2", "mel_out"):
        if name in params:
            sd.dense(name, params[name])
    for name in ("pitch_embed", "energy_embed"):
        if name in params:
            sd.put(f"{name}.weight", params[name]["Embed_0"]["embedding"])
    if "blocks" in params["decoder"]:
        _fft_blocks(sd, "decoder.blocks", params["decoder"]["blocks"])
    else:
        _conv_stacks(sd, "decoder", params["decoder"])
    return dict(sd)


def pitch_extractor_from_jax(params: Tree, batch_stats: Tree = None) -> Dict[str, torch.Tensor]:
    """``PitchExtractor`` params (+ batch_stats: the prenet's BatchNorm
    running statistics) -> the port's state_dict."""
    sd = _SD()
    pn = params["mel_prenet"]
    for i in range(sum(1 for k in pn if k.startswith("Conv_"))):
        sd.conv(f"mel_prenet.layers.{i}.0", pn[f"Conv_{i}"])
        sd.bn(f"mel_prenet.layers.{i}.2", pn[f"BatchNorm1d_{i}"],
              None if batch_stats is None else batch_stats["mel_prenet"][f"BatchNorm1d_{i}"])
    sd.dense("mel_prenet.out_proj", pn["Dense_0"])
    if "mel_encoder" in params:
        _conv_stacks(sd, "mel_encoder", params["mel_encoder"])
    _predictor(sd, "pitch_predictor", params["pitch_predictor"])
    return dict(sd)


def svbvae_mle_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """``SVBVAE(variant="mle")`` params + batch_stats -> port state_dict."""
    return svbvae_from_jax(params, batch_stats, "mle")


def discs_from_jax(disc_params: Tree, disc_batch_stats: Tree,
                   freq_length: int = 80) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adversarial task's ``disc_params``/``disc_batch_stats`` dicts
    (one entry per discriminator: ``''`` the mel discriminator, ``'_spk'``
    the speaker-consistency one) -> {name: state_dict}."""
    return {name: disc_from_jax(p, (disc_batch_stats or {}).get(name, {}), freq_length)
            for name, p in disc_params.items()}


def disc_from_jax(params: Tree, batch_stats: Tree,
                  freq_length: int = 80) -> Dict[str, torch.Tensor]:
    """Flax ``Discriminator`` params + batch_stats -> the port's
    ``mel_disc`` state_dict. Conv2d kernels [kh, kw, in, out] ->
    [out, in, kh, kw]; the head's rows go from the JAX flatten order of the
    NHWC conv output (t, f, c) to torch's NCHW order (c, t, f). A
    ``cond_disc`` subtree (the conditional branch) converts too, its
    ``mel_proj_{i}``/``cond_proj_{i}`` Dense layers into
    ``cond_disc.{mel,cond}_proj_layers.{i}``."""
    sd = _SD()
    for branch in ("discriminator", "cond_disc"):
        if branch not in params:
            continue
        p = params[branch]
        s = (batch_stats or {}).get(branch, {})
        n = sum(1 for k in p if k.startswith("disc_"))
        for i in range(n):
            dp, base = p[f"disc_{i}"], f"{branch}.discriminators.{i}"
            for j in range(3):
                conv = dp[f"conv_{j}"]
                sd.put(f"{base}.model.{j}.0.weight",
                       _np(conv["kernel"]).transpose(3, 2, 0, 1))
                sd.put(f"{base}.model.{j}.0.bias", conv["bias"])
                if f"norm_{j}" in dp:  # disc_norm 'bn'
                    st = s[f"disc_{i}"][f"norm_{j}"]
                    sd.norm(f"{base}.model.{j}.3", dp[f"norm_{j}"])
                    sd.put(f"{base}.model.{j}.3.running_mean", st["mean"])
                    sd.put(f"{base}.model.{j}.3.running_var", st["var"])
                    sd[f"{base}.model.{j}.3.num_batches_tracked"] = torch.tensor(0)
            C = _np(dp["conv_2"]["bias"]).shape[0]
            k = _np(dp["adv_layer"]["kernel"])[:, 0]
            f = freq_length
            for _ in range(3):  # three stride-2 convs with padding 1
                f = (f + 1) // 2
            t = k.shape[0] // (C * f)
            sd.put(f"{base}.adv_layer.weight",
                   k.reshape(t, f, C).transpose(2, 0, 1).reshape(1, -1))
            sd.put(f"{base}.adv_layer.bias", dp["adv_layer"]["bias"])
            for proj in ("mel_proj", "cond_proj"):
                if f"{proj}_{i}" in p:
                    sd.dense(f"{branch}.{proj}_layers.{i}", p[f"{proj}_{i}"])
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
            [_np(cell[f"i{g}"]["kernel"]).T for g in gates]))
        sd.put(f"lstm.weight_hh_l{layer}", np.concatenate(
            [_np(cell[f"h{g}"]["kernel"]).T for g in gates]))
        bias = np.concatenate([_np(cell[f"h{g}"]["bias"]) for g in gates])
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


def pwg_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``ParallelWaveGANGenerator`` params -> port state_dict; the inverse
    of ``convert_pwg`` (and of its upsample kernels' (time, freq) <->
    (freq, time) swap), plus ``pitch_embed``/``c_proj``."""
    sd = _SD()
    sd.conv("first_conv", params["first_conv"])
    up = params["upsample_net"]
    sd.conv("upsample_net.conv_in", up["conv_in"])
    n = sum(1 for k in up["upsample"] if k.startswith("conv_"))
    for i in range(n):
        k = _np(up["upsample"][f"conv_{i}"]["kernel"])  # [time, freq, 1, 1]
        sd.put(f"upsample_net.upsample.up_layers.{2 * i + 1}.weight", k.transpose(3, 2, 1, 0))
    n = sum(1 for k in params if k.startswith("block_"))
    for i in range(n):
        blk, base = params[f"block_{i}"], f"conv_layers.{i}"
        for name in ("conv", "conv1x1_aux", "conv1x1_skip", "conv1x1_out"):
            sd.conv(f"{base}.{name}", blk[name])
    sd.conv("last_conv_layers.1", params["last_conv_0"])
    sd.conv("last_conv_layers.3", params["last_conv_1"])
    if "pitch_embed" in params:
        sd.put("pitch_embed.weight", params["pitch_embed"]["Embed_0"]["embedding"])
        sd.dense("c_proj", params["c_proj"])
    return dict(sd)


def pwg_disc_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``ParallelWaveGANDiscriminator`` params (``conv_{i}``, ``conv_out``)
    -> port state_dict (``conv_layers.{2i}``, the last conv after them)."""
    sd = _SD()
    n = sum(1 for k in params if k.startswith("conv_") and k != "conv_out")
    for i in range(n):
        sd.conv(f"conv_layers.{2 * i}", params[f"conv_{i}"])
    sd.conv(f"conv_layers.{2 * n}", params["conv_out"])
    return dict(sd)


def melgan_from_jax(params: Tree, use_causal_conv: bool = False) -> Dict[str, torch.Tensor]:
    """``MelGANGenerator`` params -> the reference's flat ``melgan.{i}``
    state_dict; the inverse of ``convert_melgan_generator``."""
    sd = _SD()
    n_up = sum(1 for k in params if k.startswith("up_"))
    stacks = sum(1 for k in params if k.startswith("stack_0_"))
    conv = "{}.conv" if use_causal_conv else "{}"
    i = 0 if use_causal_conv else 1  # after the ReflectionPad1d
    sd.conv(conv.format(f"melgan.{i}"), params["conv_pre"])
    i += 1
    for si in range(n_up):
        i += 1  # the leaky ReLU
        sd.convt(f"melgan.{i}.deconv" if use_causal_conv else f"melgan.{i}",
                 params[f"up_{si}"])
        i += 1
        for j in range(stacks):
            st, base = params[f"stack_{si}_{j}"], f"melgan.{i}"
            dil, one = ("stack.1.conv", "stack.3") if use_causal_conv else ("stack.2", "stack.4")
            sd.conv(f"{base}.{dil}", st["conv_dilated"])
            sd.conv(f"{base}.{one}", st["conv_1x1"])
            sd.conv(f"{base}.skip_layer", st["skip"])
            i += 1
    i += 1 if use_causal_conv else 2  # the leaky ReLU (and the ReflectionPad1d)
    sd.conv(conv.format(f"melgan.{i}"), params["conv_post"])
    return dict(sd)


def melgan_disc_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``MelGANMultiScaleDiscriminator`` params (``scale_{i}.conv_{j}``,
    ``conv_post``) -> port state_dict (``discriminators.{i}.layers...``)."""
    sd = _SD()
    for i in range(len(params)):
        dp, base = params[f"scale_{i}"], f"discriminators.{i}.layers"
        sd.conv(f"{base}.0.1", dp["conv_0"])
        for j in range(1, 6):
            sd.conv(f"{base}.{j}.0", dp[f"conv_{j}"])
        sd.conv(f"{base}.6", dp["conv_post"])
    return dict(sd)
