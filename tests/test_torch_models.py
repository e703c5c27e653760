"""The port's networks against the JAX package's flax modules, on the CPU
in f32, at small sizes, with the flax variables carried across by
`diff_sal_tpu_torch.bridge`.

Variables are drawn with numpy from fixed seeds (fan-in-scaled kernels,
norm scales near 1, non-zero rel-pos tables and BatchNorm statistics) so
every path carries signal. Tolerance: max|d| <= 1e-4 on each output. The
pyramid comes out of LayerNorms (values O(1)) after 10 pooled-attention
blocks, and the two sides sum in different orders in f32, so agreement
is ~1e-5; 1e-4 leaves room for that without hiding a wrong term.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.models.audio_attention import AudioAttnNet as JAudioAttn
from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu.models.sal_unet import SalUNet as JSalUNet
from diff_sal_tpu.models.vggish import VGGish as JVGGish
from diff_sal_tpu.train import convert
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.models.audio_attention import AudioAttnNet
from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel
from diff_sal_tpu_torch.models.mvit import MViT
from diff_sal_tpu_torch.models.sal_unet import SalUNet
from diff_sal_tpu_torch.models.vggish import VGGish

ATOL = 1e-4


def small_av_config() -> jc.ModelConfig:
    """The small AV model of tests/test_packed_av.py."""
    return jc.ModelConfig(
        visual=jc.MViTConfig.tiny(spatial_size=(64, 96)),
        audio=jc.VGGishConfig(),
        spatiotemp=jc.AudioAttnConfig(),
        decoder=jc.SalUNetConfig(img_size=(64, 96)),
    )


def random_variables(shapes, seed: int):
    """numpy values for a flax variable tree of ShapeDtypeStructs."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        r = rng.randn(*s.shape)
        if name == "scale":
            v = 1.0 + 0.1 * r
        elif name == "var":
            v = 0.5 + 0.5 * np.abs(r)
        elif name in ("bias", "mean"):
            v = 0.05 * r
        elif name.startswith("rel_pos") or name == "cls_token":
            v = 0.1 * r
        else:
            v = r / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def full_model_variables(cfg: jc.ModelConfig, seed: int = 0):
    model = JModel(cfg)
    h, w = cfg.decoder.img_size
    t = cfg.visual.temporal_size if cfg.visual is not None else 16
    ah, aw = h // 2, w // 2
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        {"rgb": jnp.zeros((1, t, h, w, 3)), "input": jnp.zeros((1, h, w, 1)),
         "audio": jnp.zeros((1, 9, ah, aw, 1))},
        jnp.zeros((1,)),
    )
    return model, random_variables(shapes, seed)


def port_model(cfg: jc.ModelConfig, variables) -> VideoSaliencyModel:
    """The port's model with the flax variables loaded strictly."""
    model = VideoSaliencyModel(pc.from_fields(cfg)).eval()
    sd = bridge.state_dict_from_flax(variables, cfg.visual.num_layers if cfg.visual else 0)
    model.load_state_dict(sd, strict=True)
    return model


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_mvit_pyramid_matches_flax():
    cfg = jc.MViTConfig.tiny(spatial_size=(32, 48))
    x = np.random.RandomState(1).randn(2, 16, 32, 48, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 2)
    ref = jax.jit(jm.apply)(variables, x)
    pm = MViT(pc.from_fields(cfg)).eval()
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                        bridge.export_mvit(variables["params"], cfg.num_layers).items()},
                       strict=True)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        _close(o, r)


def test_vggish_audio_attn_features_match_flax():
    rng = np.random.RandomState(3)
    frames = rng.randn(4, 32, 48, 1).astype(np.float32)
    jv, ja = JVGGish(), JAudioAttn()
    vv = random_variables(jax.eval_shape(
        lambda k, x: jv.init(k, x, method=JVGGish.forward_feat), jax.random.PRNGKey(0), frames), 4)
    ref_feat = jax.jit(lambda v, x: jv.apply(v, x, method=JVGGish.forward_feat))(vv, frames)
    tokens = np.array(ref_feat).reshape(2, 2, *ref_feat.shape[1:])
    av = random_variables(jax.eval_shape(ja.init, jax.random.PRNGKey(0), tokens), 5)
    ref = jax.jit(ja.apply)(av, tokens)

    pv, pa = VGGish(), AudioAttnNet()
    pv.load_state_dict({k: torch.from_numpy(v) for k, v in
                        bridge.export_vggish(vv["params"]).items()}, strict=True)
    pa.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                        bridge.export_audio_attn(av["params"]).items()}, strict=True)
    feat = pv.forward_feat(torch.from_numpy(frames))
    _close(feat, ref_feat)
    with torch.no_grad():
        _close(pa(torch.from_numpy(tokens)), ref)


def test_salunet_denoise_matches_flax():
    """The decoder at the small AV size with audio, DDIM's t=0, the
    default dead-frame cuts on both sides."""
    dcfg = jc.SalUNetConfig(img_size=(64, 96))
    rng = np.random.RandomState(6)
    feats = [rng.randn(2, 8, 2 * 2 ** i, 3 * 2 ** i, c).astype(np.float32)
             for i, c in enumerate((768, 384, 192, 96))]
    audio = rng.randn(2, 9, 2, 3, 512).astype(np.float32)
    x = rng.randn(2, 64, 96, 1).astype(np.float32)
    t = np.zeros((2,), np.float32)
    jm = JSalUNet(dcfg)
    variables = random_variables(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, feats, audio), 7)
    ref = jax.jit(jm.apply)(variables, x, t, feats, audio)

    pm = SalUNet(pc.from_fields(dcfg), with_audio=True).eval()
    sd = bridge._with_bn_counters(bridge.export_salunet(variables["params"],
                                                        variables["batch_stats"]))
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        out = pm(*map(torch.from_numpy, (x, t)), [torch.from_numpy(f) for f in feats],
                 torch.from_numpy(audio))
    assert tuple(out.shape) == (2, 64, 96, 1)
    _close(out, ref)


def test_bridge_agrees_with_convert_exporters_key_for_key():
    """The port's own layout rules give the JAX package's export_mvit and
    export_salunet state dicts (plus BatchNorm's num_batches_tracked), and
    the whole model's state_dict loads strictly."""
    cfg = small_av_config()
    _, variables = full_model_variables(cfg, seed=8)
    sd = bridge.state_dict_from_flax(variables, cfg.visual.num_layers if cfg.visual else 0)
    params, stats = variables["params"], variables["batch_stats"]
    ref = {f"visual_net.{k}": v for k, v in
           convert.export_mvit(params["visual_net"], cfg.visual.num_layers).items()}
    ref.update({f"decoder_net.{k}": v for k, v in
                convert.export_salunet(params["decoder_net"], stats["decoder_net"]).items()})
    ours = {k: v for k, v in sd.items() if k.split(".")[0] in ("visual_net", "decoder_net")}
    counters = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - counters == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    port = VideoSaliencyModel(pc.from_fields(cfg))
    port.load_state_dict(sd, strict=True)
    assert set(sd) == set(port.state_dict())


def test_from_fields_keeps_only_function_changing_fields():
    jcfg = dataclasses.replace(jc.ModelConfig.audio_visual(), compute_dtype="bfloat16")
    pcfg = pc.from_fields(jcfg)
    assert pcfg == pc.ModelConfig.audio_visual(compute_dtype="bfloat16")
    assert not hasattr(pcfg.visual, "use_pallas_attention")
    assert pcfg.decoder.skip_dead_frames_all and pcfg.visual.gelu == "tanh"
