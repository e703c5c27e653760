"""Flax variables of the JAX package -> the port's `state_dict`.

Takes the variables as nested dicts of numpy arrays (`{"params": ...,
"batch_stats": ...}`) and returns a flat dict of torch tensors under the
reference's torch names, which `VideoSaliencyModel.load_state_dict(...,
strict=True)` accepts. The layout rules are the port's own copy of the JAX
package's `train/convert.py` exporters:

  Linear           kernel (I, O)           -> weight (O, I)
  quantised Linear kernel_q (I, O) int8, kernel_scale (O,)
                                           -> weight_q (O, I), weight_scale
  Conv2d           kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
  Conv3d           kernel (kt, kh, kw, I, O) -> weight (O, I, kt, kh, kw)
  depthwise Conv3d kernel (kt, kh, kw, 1, C) -> weight (C, 1, kt, kh, kw)
  CvT projections  2-D depthwise kernel -> Conv3d weight with only the
                   centre temporal slice set (they act on a T=1 grid)
  LayerNorm / GroupNorm / BatchNorm scale, bias -> weight, bias
  BatchNorm batch_stats mean, var -> running_mean, running_var

plus the inverses of the JAX package's `convert_vggish` and
`convert_audio_attn`, which it has only in the import direction.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _inv_linear(k):
    return _np(k).T


def _inv_conv2d(k):
    return _np(k).transpose(3, 2, 0, 1)


def _inv_conv3d(k):
    return _np(k).transpose(4, 3, 0, 1, 2)


def _inv_dw2d_to_3d_center(k, kt=3):
    k2 = _np(k).transpose(3, 2, 0, 1)  # (C, 1, kh, kw)
    out = np.zeros((k2.shape[0], 1, kt, k2.shape[2], k2.shape[3]), k2.dtype)
    out[:, :, kt // 2] = k2
    return out


def _ln(sd: Dict, prefix: str, p: Mapping):
    sd[prefix + ".weight"] = _np(p["scale"])
    sd[prefix + ".bias"] = _np(p["bias"])


def _lin(sd: Dict, prefix: str, p: Mapping):
    if "kernel_q" in p:  # a quantised Dense (ops/quant.py)
        sd[prefix + ".weight_q"] = _inv_linear(p["kernel_q"])
        sd[prefix + ".weight_scale"] = _np(p["kernel_scale"])
    else:
        sd[prefix + ".weight"] = _inv_linear(p["kernel"])
    if "bias" in p:
        sd[prefix + ".bias"] = _np(p["bias"])


def _conv(sd: Dict, prefix: str, p: Mapping):
    sd[prefix + ".weight"] = _inv_conv2d(p["kernel"])
    if "bias" in p:
        sd[prefix + ".bias"] = _np(p["bias"])


def export_mvit(params: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {
        "patch_embed.projection.weight": _inv_conv3d(params["patch_embed"]["projection"]["kernel"]),
        "patch_embed.projection.bias": _np(params["patch_embed"]["projection"]["bias"]),
        "cls_token": _np(params["cls_token"]),
    }
    for i in range(num_layers):
        blk = params[f"blocks_{i}"]
        pfx = f"blocks.{i}."
        _ln(sd, pfx + "norm1", blk["norm1"])
        _ln(sd, pfx + "norm2", blk["norm2"])
        for fc in ("fc1", "fc2"):
            _lin(sd, pfx + f"mlp.{fc}", blk["mlp"][fc])
        at = blk["attn"]
        _lin(sd, pfx + "attn.qkv", at["qkv"])
        _lin(sd, pfx + "attn.proj", at["proj"])
        for p in ("t", "h", "w"):
            sd[pfx + f"attn.rel_pos_{p}"] = _np(at[f"rel_pos_{p}"])
        for p in ("q", "k", "v"):
            sd[pfx + f"attn.pool_{p}.weight"] = _inv_conv3d(at[f"pool_{p}"]["pool"]["kernel"])
            _ln(sd, pfx + f"attn.norm_{p}", at[f"pool_{p}"]["norm"])
        if "proj" in blk:
            _lin(sd, pfx + "proj", blk["proj"])
    for s in range(4):
        if f"norm{s}" in params:
            _ln(sd, f"norm{s}", params[f"norm{s}"])
    return sd


def export_salunet(params: Mapping, batch_stats: Mapping,
                   num_stages: int = 4) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for j in (0, 1):
        _lin(sd, f"temb.dense.{j}", params["temb"][f"dense{j}"])
    ne = params["noise_encoder"]
    _conv(sd, "conv_in", ne["conv_in"])
    _conv(sd, "down1.conv", ne["down1"]["conv"])
    for i in range(3):
        rb = ne[f"res{i}"]
        pfx = f"res_encoder.{i}.0."
        for nm in ("norm1", "norm2"):
            _ln(sd, pfx + nm, rb[nm])
        for nm in ("conv1", "conv2"):
            _conv(sd, pfx + nm, rb[nm])
        _lin(sd, pfx + "temb_proj", rb["temb_proj"])
        if "nin_shortcut" in rb:
            _conv(sd, pfx + "nin_shortcut", rb["nin_shortcut"])
        _conv(sd, f"res_encoder.{i}.1.conv", ne[f"res_down{i}"]["conv"])
    dec = params["decoder"]
    dstats = batch_stats.get("decoder", {})
    for i in range(num_stages):
        st = dec[f"stage{i}"]
        spfx = f"invpt_decoder.mid_stages.{i}."
        if "patch_embed" in st:
            pe = st["patch_embed"]
            pe_stats = dstats.get(f"stage{i}", {}).get("patch_embed", {})
            for j, (ci, bi) in enumerate([(1, 2), (4, 5)]):
                sd[spfx + f"patch_embed.0.proj.{ci}.weight"] = _inv_conv2d(pe[f"conv{j}"]["kernel"])
                _ln(sd, spfx + f"patch_embed.0.proj.{bi}", pe[f"bn{j}"])
                if pe_stats:
                    sd[spfx + f"patch_embed.0.proj.{bi}.running_mean"] = _np(pe_stats[f"bn{j}"]["mean"])
                    sd[spfx + f"patch_embed.0.proj.{bi}.running_var"] = _np(pe_stats[f"bn{j}"]["var"])
        bpfx = spfx + "blocks.0."
        blk = st["block"]
        for nm in ("norm", "norm2"):
            _ln(sd, bpfx + nm, blk[nm])
        for fc in ("fc1", "fc2"):
            _lin(sd, bpfx + f"mlp.{fc}", blk["mlp"][fc])
        if "align_conv" in blk:
            _conv(sd, bpfx + "align_conv", blk["align_conv"])
        at = blk["attn"]
        for p in ("q", "k", "v"):
            sd[bpfx + f"attn.conv_proj_{p}.conv.weight"] = _inv_dw2d_to_3d_center(
                at[f"conv_proj_{p}"]["kernel"], 3 if p == "q" else 1)
            _ln(sd, bpfx + f"attn.conv_proj_{p}.bn", at[f"norm_{p}"])
            _lin(sd, bpfx + f"attn.proj_{p}", at[f"proj_{p}"])
        _lin(sd, bpfx + "attn.proj", at["proj"])
        _ln(sd, f"invpt_decoder.norm_mts.{i}", dec[f"norm_mt{i}"])
        sd[f"invpt_decoder.redu_chan_up.{i}.proj.0.weight"] = _inv_conv3d(
            dec[f"redu_chan{i}"]["conv"]["kernel"])
    _conv(sd, "invpt_decoder.mt_proj.0", dec["mt_proj"]["conv"])
    _ln(sd, "invpt_decoder.mt_proj.1", dec["mt_proj"]["bn"])
    mtbn = dstats.get("mt_proj", {}).get("bn")
    if mtbn is not None:
        sd["invpt_decoder.mt_proj.1.running_mean"] = _np(mtbn["mean"])
        sd["invpt_decoder.mt_proj.1.running_var"] = _np(mtbn["var"])
    _conv(sd, "logits.linear_pred", params["logits"]["linear_pred"])
    return sd


# torch Sequential indices of the VGGish convs (reference models/vggish.py)
_VGGISH_CONV_IDS = (0, 3, 6, 8, 11, 13)


def export_vggish(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of the JAX package's `convert_vggish` (trunk only)."""
    sd: Dict[str, np.ndarray] = {}
    for i, lid in enumerate(_VGGISH_CONV_IDS):
        _conv(sd, f"features.{lid}", params["features"][f"conv{i}"])
    return sd


def export_audio_attn(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of the JAX package's `convert_audio_attn`."""
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"attn{i}" in params:
        att = f"transformer.layers.{i}.0."
        ff = f"transformer.layers.{i}.1."
        a, f = params[f"attn{i}"], params[f"ff{i}"]
        _ln(sd, att + "norm", a["norm"])
        _lin(sd, att + "to_qkv", a["to_qkv"])
        _lin(sd, att + "to_out.0", a["to_out"])
        _ln(sd, ff + "net.0", f["norm"])
        _lin(sd, ff + "net.1", f["fc1"])
        _lin(sd, ff + "net.4", f["fc2"])
        i += 1
    _ln(sd, "transformer.norm", params["final_norm"])
    return sd


def _with_bn_counters(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torch's BatchNorm2d also keeps `num_batches_tracked`."""
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_mean"):
            out[k[: -len("running_mean")] + "num_batches_tracked"] = np.array(0, np.int64)
    return out


def state_dict_from_flax(variables: Mapping, num_mvit_layers: int) -> Dict[str, torch.Tensor]:
    """Full VideoSaliencyModel variables -> the port's state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    parts = {
        "visual_net": lambda p: export_mvit(p, num_mvit_layers),
        "audio_net": export_vggish,
        "spatiotemp_net": export_audio_attn,
        "decoder_net": lambda p: _with_bn_counters(
            export_salunet(p, stats.get("decoder_net", {}))),
    }
    for name, export in parts.items():
        if name in params:
            sd.update({f"{name}.{k}": v for k, v in export(params[name]).items()})
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
