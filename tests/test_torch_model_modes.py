"""The two model modes of the port beyond the default: MViT without its
cls token (`MViTConfig.with_cls_token=False`) and the random-pyramid
ablation (`ModelConfig.visual=None`), against the JAX package on the CPU.

MViT without its cls token. JAX runs the blocks on the spatial tokens
alone through its einsum attention (`diff_sal_tpu/models/mvit.py:838-851`:
bf16 scores, the rel-pos bias and the softmax in f32, `+ q` on every row,
one rounding before `proj`) and forces `cls_stream`, the Pallas attention
and the Pallas pool off (:807-811, :1509, :1577). Tolerances, f32: one
attention 1e-5 (the same f32 function, other summation order); the tiny
MViT's pyramid 1e-4 (tests/test_torch_models.py's per-network bound), in
each of the port's flag settings against JAX's with `cls_stream`,
`use_pallas_attention` and `pool_mode="pallas"` set, which JAX ignores
here; the visual-only model through DDIM NFE 1 1e-4 on the map. bf16: the
port's attention and JAX's each against the port's f64 attention, the
port no further than a quarter more than JAX (two bf16 paths that round
at the same points and sum in other orders) and the two within 2e-2 of
each other (a few bf16 ulps of the O(1) output). One training step of the
visual-only model (`MViTConfig.dryrun()` at 64x96, B=1, dropout and DropPath
0) against JAX's: the loss 1e-5, every gradient leaf as
`assert_gradient_leaves_match` holds it (each f32 side within its own
rounding of the port's f64 step, the two within 4x the larger), the ReLU
branches and MViT's skip-pool winners pinned to the f64 step's
(`ReluBranches`). `cls_token` gets no gradient in the port (nothing reads
it) and a zero one in JAX; after Adam both leave it where it was.
`remat` on against off: the same loss bit for bit and gradients within
1e-6 of the largest; `mlp_quant="w8"` against JAX's on the same int8
weights: 1e-5 of max(1, max|x|) (tests/test_torch_quant.py's bound).

The random pyramid. JAX draws (B, T/2, H/4 >> (3-i), W/4 >> (3-i), c),
c = 768, 384, 192, 96, in the rgb's dtype after uint8 normalisation,
from a 'pyramid' rng, and raises without one (diff_model.py:75-107); the
port draws from a `torch.Generator` and raises `ValueError` without one.
The draws differ, so shapes and dtypes are compared (uint8 input
included) and JAX's pyramid is handed to the port's `denoise`: the
decoder-only ablation and the ablation with the audio path against JAX's
whole apply with that rng, 1e-4 (per network). Neither package's
`sample_saliency` nor train step passes a pyramid rng or generator, so
both raise for this config.

`chip_smoke.path_launches` for both structures is held to the wrapper
calls a DDIM run and a training step make on the CPU (the plain routes
counted where the card would launch).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu.inference import sample_saliency as j_sample
from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
from diff_sal_tpu.models.mvit import MultiScaleAttention as JAttention
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu.ops import quant as jq
from diff_sal_tpu.train import convert as jconvert
from diff_sal_tpu.train.optim import make_optimizer as j_make_optimizer
from diff_sal_tpu.train.train_step import create_train_state
from diff_sal_tpu.train.train_step import make_train_step as j_make_train_step
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.diffusion.schedule import make_schedule
from diff_sal_tpu_torch.inference import sample_saliency
from diff_sal_tpu_torch.models.diff_model import (PYRAMID_DIMS, VideoSaliencyModel,
                                                  build_model, param_counts)
from diff_sal_tpu_torch.models.mvit import MultiScaleAttention, MViT
from diff_sal_tpu_torch.ops import quant as tq
from diff_sal_tpu_torch.train import convert
from diff_sal_tpu_torch.train.optim import make_optimizer
from diff_sal_tpu_torch.train.train_step import make_train_step
from test_torch_models import full_model_variables, port_model, random_variables
from test_torch_train_step import (ReluBranches, _stash_grads, assert_gradient_leaves_match,
                                   one_torch_thread, port_f32_step, port_f64_step)

REPO = Path(__file__).resolve().parents[1]
B = 2
HW = (32, 48)
SMALL = (64, 96)
F32_NET = dict(atol=1e-4, rtol=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _mvit_sd(variables, num_layers):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            bridge.export_mvit(variables["params"], num_layers).items()}


# ------------------------------------------------ MViT without cls token ---

@pytest.fixture(scope="module")
def no_cls_mvit():
    """JAX's tiny MViT without its cls token, with the three flags it
    ignores then set, its random variables, an input and its pyramid."""
    cfg = jc.MViTConfig.tiny(spatial_size=HW, with_cls_token=False, cls_stream=True,
                             use_pallas_attention=True, pool_mode="pallas")
    x = np.random.RandomState(181).randn(B, 16, *HW, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 182)
    ref = [np.asarray(r) for r in jax.jit(jm.apply)(variables, x)]
    return cfg, x, variables, ref


@pytest.mark.parametrize("cls_stream,pool_mode", [(True, "conv"), (False, "conv"),
                                                  (True, "pallas")])
def test_tiny_mvit_without_cls_token_matches_jax(no_cls_mvit, cls_stream, pool_mode):
    cfg, x, variables, ref = no_cls_mvit
    pcfg = dataclasses.replace(pc.from_fields(cfg), cls_stream=cls_stream, pool_mode=pool_mode)
    assert not pcfg.with_cls_token
    pm = MViT(pcfg).eval()
    # JAX creates cls_token in this mode too: one parameter tree, strict loads
    assert "cls_token" in variables["params"]
    pm.load_state_dict(_mvit_sd(variables, cfg.num_layers), strict=True)
    # no K11 pool without the cls stream, whatever pool_mode says
    assert all(b.attn.pool_mode == "conv" and not b.attn.cls_stream for b in pm.blocks)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, **F32_NET)


def test_the_parameter_tree_is_the_same_with_and_without_cls_token():
    """With the strict load of JAX's variables above, this is JAX's tree
    (tests/test_torch_models.py loads the cls-token one)."""
    sds = [MViT(pc.MViTConfig.tiny(spatial_size=HW, with_cls_token=c)).state_dict()
           for c in (True, False)]
    assert {k: v.shape for k, v in sds[0].items()} == {k: v.shape for k, v in sds[1].items()}


ATTN = dict(in_dims=32, out_dims=64, num_heads=2, stride_q=(1, 2, 2), stride_kv=(1, 4, 4),
            rel_pos_dims=(7, 15), in_size=(4, 8, 12))


def _attention_pair(dtype):
    """JAX's `MultiScaleAttention` without the cls token (its einsum path)
    on random variables and an input, and the port's module on the same
    weights: (JAX output, port module, input)."""
    a = ATTN
    jm = JAttention(out_dims=a["out_dims"], num_heads=a["num_heads"], stride_q=a["stride_q"],
                    stride_kv=a["stride_kv"], with_cls_token=False,
                    rel_pos_dims=a["rel_pos_dims"], dtype=dtype)
    L = int(np.prod(a["in_size"]))
    x = np.random.RandomState(183).randn(B, L, a["in_dims"]).astype(np.float32)
    v = random_variables(jax.eval_shape(lambda k, x: jm.init(k, x, a["in_size"]),
                                        jax.random.PRNGKey(0), x), 184)
    out, q_shape = jax.jit(lambda v, x: jm.apply(v, x, a["in_size"]))(v, x)
    assert tuple(q_shape) == (4, 4, 6)
    p = v["params"]
    pm = MultiScaleAttention(a["in_dims"], a["out_dims"], a["num_heads"], a["stride_q"],
                             a["stride_kv"], a["rel_pos_dims"])
    sd = {"qkv.weight": p["qkv"]["kernel"].T, "qkv.bias": p["qkv"]["bias"],
          "proj.weight": p["proj"]["kernel"].T, "proj.bias": p["proj"]["bias"]}
    for t in "thw":
        sd[f"rel_pos_{t}"] = p[f"rel_pos_{t}"]
    for q in "qkv":
        sd[f"pool_{q}.weight"] = p[f"pool_{q}"]["pool"]["kernel"].transpose(4, 3, 0, 1, 2)
        sd[f"norm_{q}.weight"] = p[f"pool_{q}"]["norm"]["scale"]
        sd[f"norm_{q}.bias"] = p[f"pool_{q}"]["norm"]["bias"]
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       strict=True)
    return np.asarray(out.astype(jnp.float32)), out.dtype, pm, torch.from_numpy(x)


def _port_attention(pm, x, dt):
    with torch.no_grad():
        out, cls, q_shape = pm(x, None, ATTN["in_size"], dt)
    assert cls is None and q_shape == (4, 4, 6)
    return out


def test_attention_without_cls_token_matches_jax_einsum_path_f32():
    ref, _, pm, x = _attention_pair(None)
    out = _port_attention(pm, x, None)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_attention_without_cls_token_rounds_where_jax_does_bf16():
    """bf16 scores, the f32 bias promoting the softmax and the product with
    v to f32, one rounding before `proj`: the port's bf16 attention is no
    further from the f64 one than JAX's, up to a quarter more."""
    ref, jdt, pm, x = _attention_pair(jnp.bfloat16)
    assert jdt == jnp.bfloat16
    out = _port_attention(pm, x, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref64 = _port_attention(pm.double(), x.double(), None).numpy()
    got = out.float().numpy()
    e_port = float(np.linalg.norm(got - ref64) / np.linalg.norm(ref64))
    e_jax = float(np.linalg.norm(ref - ref64) / np.linalg.norm(ref64))
    print(f"bf16 attention vs f64, relative L2: port {e_port:.3e}, JAX {e_jax:.3e}")
    assert e_port <= 1.25 * e_jax, (e_port, e_jax)
    assert float(np.abs(got - ref).max()) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


def visual_only_no_cls(mvit=jc.MViTConfig.dryrun) -> jc.ModelConfig:
    return dataclasses.replace(
        jc.ModelConfig.visual_only(), visual=mvit(spatial_size=SMALL, with_cls_token=False),
        decoder=jc.SalUNetConfig(img_size=SMALL, dropout=0.0, drop_path_rate=(0.0,) * 4))


def test_visual_only_without_cls_token_sample_saliency_matches_jax():
    cfg = visual_only_no_cls()
    jmodel, variables = full_model_variables(cfg, seed=185)
    rgb = np.random.RandomState(186).randn(B, 16, *SMALL, 3).astype(np.float32)
    sampling, data_cfg = jc.SamplingConfig(), jc.DataTransformConfig()
    key = jax.random.PRNGKey(187)
    sched = j_make_schedule()
    ref = jax.jit(lambda v, r: j_sample(jmodel, v, sched, sampling, data_cfg, r, None, key))(
        variables, rgb)
    noise = jax.random.normal(jax.random.split(key, 3)[1], (B, *SMALL, 1))
    model = port_model(cfg, variables)
    assert not model.cfg.visual.with_cls_token
    out = sample_saliency(model, make_schedule(), pc.from_fields(sampling),
                          pc.from_fields(data_cfg), torch.from_numpy(rgb),
                          noise=torch.from_numpy(np.array(noise)))
    assert tuple(out.shape) == (B, *SMALL, 1) and float(out.std()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_NET)


@pytest.fixture(scope="module")
def no_cls_step():
    """One JAX train step and the port's f32 and f64 steps of the
    visual-only model without the cls token, same weights, batch and
    draws, the f64 step's ReLU branches and pool winners taken by the
    others."""
    cfg = jc.ExperimentConfig(model=visual_only_no_cls(), optim=jc.OptimConfig(lr=1e-4))
    jmodel, variables = full_model_variables(cfg.model, seed=188)
    rng = np.random.RandomState(189)
    b = 1  # the batch-statistics BatchNorms take the (H, W) rows
    batch = {"rgb": rng.randn(b, 16, *SMALL, 3).astype(np.float32),
             "salmap": rng.rand(b, *SMALL, 1).astype(np.float32)}
    key = jax.random.PRNGKey(190)
    sched = j_make_schedule()
    k_deq, k_t, k_noise, _ = jax.random.split(key, 4)
    shape = (b, *SMALL, 1)
    draws = {"deq": jax.random.normal(k_deq, shape), "noise": jax.random.normal(k_noise, shape),
             "t": jax.random.randint(k_t, (), 0, sched.num_timesteps)}
    branches = ReluBranches()
    ref64 = port_f64_step(cfg, variables, batch, draws, branches)
    tx = optax.chain(_stash_grads(), j_make_optimizer(cfg.optim, steps_per_epoch=4, n_epochs=2))
    state = create_train_state(jmodel, variables, tx)
    with ReluBranches.pinned_jax(branches):
        new_state, metrics = jax.jit(j_make_train_step(jmodel, sched, cfg))(
            state, jax.tree.map(jnp.asarray, batch), key)
    n = cfg.model.visual.num_layers
    grads = bridge.state_dict_from_flax({"params": jax.device_get(new_state.opt_state[0])}, n)
    after = bridge.state_dict_from_flax({"params": jax.device_get(new_state.params)}, n)
    model, port_metrics, before = port_f32_step(cfg, variables, batch, draws, branches)
    return ({k: float(v) for k, v in metrics.items()}, grads, after, model, port_metrics,
            before, ref64)


def test_no_cls_train_step_loss_matches_jax(no_cls_step):
    jax_metrics, _, _, _, metrics, _, _ = no_cls_step
    for k in ("total", "main"):
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_metrics["grad_norm"], rtol=1e-4)


def test_no_cls_train_step_gradients_match_jax(no_cls_step):
    _, grads, after, model, _, before, ref64 = no_cls_step
    assert_gradient_leaves_match(grads, model, ref64["grads"], min_leaves=200)
    cls = model.get_parameter("visual_net.cls_token")
    assert cls.grad is None and not grads["visual_net.cls_token"].any()
    # Adam moves neither: the port counts a None gradient as zeros, as optax
    # takes JAX's zero one
    assert torch.equal(cls.detach(), before["visual_net.cls_token"])
    assert torch.equal(cls.detach(), after["visual_net.cls_token"])
    for name in ("visual_net.blocks.0.attn.rel_pos_h", "visual_net.blocks.0.attn.norm_q.weight",
                 "visual_net.blocks.1.attn.pool_k.weight", "visual_net.blocks.1.proj.weight"):
        assert float(model.get_parameter(name).grad.abs().max()) > 0, name


def test_remat_without_cls_token_equals_the_plain_step():
    cfg = pc.MViTConfig.dryrun(spatial_size=HW, with_cls_token=False)
    g = torch.Generator().manual_seed(191)
    x = torch.randn(1, 16, *HW, 3, generator=g)
    base = MViT(cfg)
    with torch.no_grad():
        for p in base.parameters():
            p.normal_(0, 0.05, generator=g)
    sd = base.state_dict()
    ws = [torch.randn(o.shape, generator=g) for o in base(x)]
    runs = []
    for remat in (False, True):
        m = MViT(dataclasses.replace(cfg, remat=remat)).train()
        m.load_state_dict(sd)
        loss = sum((o * w).sum() for o, w in zip(m(x), ws))
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}))
    (l_off, g_off), (l_on, g_on) = runs
    assert l_on == l_off
    top = max(float(v.abs().max()) for v in g_off.values() if v is not None)
    assert g_off["cls_token"] is None and g_on["cls_token"] is None
    n = 0
    for name, v in g_off.items():
        if v is not None:
            assert float((g_on[name] - v).abs().max()) <= 1e-6 * top, name
            n += 1
    assert n > 100


def test_w8_mlp_without_cls_token_matches_jax():
    base = jc.MViTConfig.dryrun(spatial_size=HW, with_cls_token=False)
    cfg_q = dataclasses.replace(base, mlp_quant="w8")
    x = np.random.RandomState(192).randn(B, 16, *HW, 3).astype(np.float32)
    fp_vars = random_variables(jax.eval_shape(JMViT(base).init, jax.random.PRNGKey(0), x), 193)
    jm_q = JMViT(cfg_q)
    q_vars = jq.quantize_like(fp_vars, jax.eval_shape(jm_q.init, jax.random.PRNGKey(0), x))
    ref = [np.asarray(r) for r in jax.jit(jm_q.apply)(q_vars, x)]
    pm = MViT(pc.from_fields(cfg_q)).eval()
    pm.load_state_dict(tq.quantize_state_dict(_mvit_sd(fp_vars, base.num_layers),
                                              pm.state_dict()), strict=True)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(r).max())))


# --------------------------------------------------- the random pyramid ---

def ablation(audio: bool) -> jc.ModelConfig:
    return jc.ModelConfig(visual=None, audio=jc.VGGishConfig() if audio else None,
                          spatiotemp=jc.AudioAttnConfig() if audio else None,
                          decoder=jc.SalUNetConfig(img_size=SMALL))


def test_random_pyramid_shapes_and_dtypes_are_jaxs():
    cfg = ablation(False)
    jm = JModel(cfg)
    model = VideoSaliencyModel(pc.from_fields(cfg))
    assert model.visual_net is None
    g = torch.Generator().manual_seed(194)
    for dtype, t_dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                           (jnp.uint8, torch.uint8)):
        for hw in ((64, 96), (224, 384)):
            rgb = jax.ShapeDtypeStruct((B, 16, *hw, 3), dtype)
            ref = jax.eval_shape(lambda r: jm.apply({}, r, method=JModel.encode_visual,
                                                    rngs={"pyramid": jax.random.PRNGKey(1)}), rgb)
            got = model.encode_visual(torch.zeros((B, 16, *hw, 3), dtype=t_dtype), g)
            assert [(tuple(o.shape), str(o.dtype).split(".")[-1]) for o in got] \
                == [(r.shape, str(r.dtype)) for r in ref]
    assert [o.shape[-1] for o in got] == list(PYRAMID_DIMS)
    assert [tuple(o.shape[1:4]) for o in got] == [(8, 7, 12), (8, 14, 24), (8, 28, 48),
                                                  (8, 56, 96)]


def test_random_pyramid_is_fresh_per_generator_and_equal_per_seed():
    model = VideoSaliencyModel(pc.from_fields(ablation(False)))
    rgb = torch.zeros(B, 16, *SMALL, 3)

    def draw(seed):
        return model.encode_visual(rgb, torch.Generator().manual_seed(seed))

    a, a2, b = draw(1), draw(1), draw(2)
    assert all(torch.equal(x, y) for x, y in zip(a, a2))
    assert not any(torch.equal(x, y) for x, y in zip(a, b))
    g = torch.Generator().manual_seed(1)
    first, second = model.encode_visual(rgb, g), model.encode_visual(rgb, g)
    assert not any(torch.equal(x, y) for x, y in zip(first, second))
    # standard normal draws
    flat = torch.cat([x.flatten() for x in a])
    assert abs(float(flat.mean())) < 0.05 and abs(float(flat.std()) - 1.0) < 0.05


def test_random_pyramid_raises_without_a_generator_as_jax_without_its_rng():
    cfg = ablation(False)
    rgb = np.zeros((B, 16, *SMALL, 3), np.float32)
    x = np.zeros((B, *SMALL, 1), np.float32)
    with pytest.raises(ValueError, match="pyramid"):
        jax.eval_shape(lambda r: JModel(cfg).apply({}, r, method=JModel.encode_visual), rgb)
    model = build_model(pc.from_fields(cfg), seed=195, device="cpu")
    data = {"rgb": torch.from_numpy(rgb), "input": torch.from_numpy(x)}
    with torch.no_grad():
        with pytest.raises(ValueError, match="generator"):
            model.encode_visual(data["rgb"])
        with pytest.raises(ValueError, match="generator"):
            model(data, torch.zeros(B))
        # the dropout generator is not the pyramid's
        with pytest.raises(ValueError, match="generator"):
            model(data, torch.zeros(B), generator=torch.Generator().manual_seed(0))
        out = model(data, torch.zeros(B), pyramid_generator=torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (B, *SMALL, 1) and bool(torch.isfinite(out).all())


@pytest.fixture(scope="module")
def ablations():
    """JAX's decoder-only and AV ablations: each one's whole apply with a
    'pyramid' rng and the pyramid that rng draws, one jit."""
    out = {}
    rng = np.random.RandomState(196)
    rgb = rng.randn(B, 16, *SMALL, 3).astype(np.float32)
    audio = rng.randn(B, 9, SMALL[0] // 2, SMALL[1] // 2, 1).astype(np.float32)
    x = rng.randn(B, *SMALL, 1).astype(np.float32)
    t = np.array([0.0, 500.0], np.float32)
    rngs = {"pyramid": jax.random.PRNGKey(197)}
    for name, with_audio in (("decoder_only", False), ("audio_visual", True)):
        cfg = ablation(with_audio)
        jm, variables = full_model_variables(cfg, 198 + with_audio)
        assert "visual_net" not in variables["params"]
        data = {"rgb": rgb, "input": x}
        if with_audio:
            data["audio"] = audio

        def run(v, data, t, jm=jm):
            whole = jm.apply(v, data, t, rngs=rngs)
            feats = jm.apply(v, data["rgb"], method=JModel.encode_visual, rngs=rngs)
            return whole, feats

        whole, feats = jax.jit(run)(variables, data, t)
        out[name] = (cfg, variables, data, t, np.asarray(whole), [np.asarray(f) for f in feats])
    return out


@pytest.mark.parametrize("name", ["decoder_only", "audio_visual"])
def test_denoise_on_jaxs_pyramid_matches_jaxs_apply(ablations, name):
    cfg, variables, data, t, ref, feats = ablations[name]
    model = port_model(cfg, variables)
    assert model.visual_net is None
    assert (model.audio_net is not None) == (name == "audio_visual")
    d = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        audio_feat = model.encode_audio(d["audio"]) if "audio" in d else None
        out = model.denoise(d["input"], torch.from_numpy(t), [torch.from_numpy(f) for f in feats],
                            audio_feat)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **F32_NET)


def test_ablation_without_visual_net_loads_imports_and_counts(ablations, tmp_path):
    """Bridged variables load strictly; a reference-format file of the AV
    ablation imports through `convert_checkpoint("full")` and loads
    strictly; `param_counts` and `init_weights` take the model."""
    cfg, variables, _, _, _, _ = ablations["audio_visual"]
    model = port_model(cfg, variables)
    counts = param_counts(model)
    assert set(counts) == {"audio_net", "spatiotemp_net", "decoder_net"}
    p, s = variables["params"], variables["batch_stats"]
    parts = {"audio_net": bridge.export_vggish(p["audio_net"]),
             "spatiotemp_net": bridge.export_audio_attn(p["spatiotemp_net"]),
             "decoder_net": jconvert.export_salunet(p["decoder_net"], s["decoder_net"])}
    ref_sd = {f"module.{sub}.{k}": torch.from_numpy(np.array(v, np.float32))
              for sub, part in parts.items() for k, v in part.items()}
    sd, _ = convert.convert_checkpoint(ref_sd, "full")
    fresh = VideoSaliencyModel(pc.from_fields(cfg))
    fresh.load_state_dict(sd, strict=True)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k
    built = build_model(pc.from_fields(cfg), seed=199, device="cpu")
    assert built.visual_net is None and set(param_counts(built)) == set(counts)


@pytest.mark.parametrize("name", ["decoder_only", "audio_visual"])
def test_sample_saliency_and_train_step_raise_on_both_sides(ablations, name):
    cfg, variables, data, _, _, _ = ablations[name]
    sched = j_make_schedule()
    sampling, data_cfg = jc.SamplingConfig(), jc.DataTransformConfig()
    with pytest.raises(ValueError, match="pyramid"):
        jax.eval_shape(lambda v, r: j_sample(JModel(cfg), v, sched, sampling, data_cfg, r),
                       variables, data["rgb"])
    ecfg = jc.ExperimentConfig(model=cfg)
    jmodel = JModel(cfg)
    state = create_train_state(jmodel, variables,
                               j_make_optimizer(ecfg.optim, steps_per_epoch=4, n_epochs=2))
    batch = {"rgb": data["rgb"], "salmap": np.full((B, *SMALL, 1), 0.5, np.float32)}
    if "audio" in data:
        batch["audio"] = data["audio"]
    with pytest.raises(ValueError, match="pyramid"):
        jax.eval_shape(j_make_train_step(jmodel, sched, ecfg), state, batch,
                       jax.random.PRNGKey(0))

    model = port_model(cfg, variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="generator"):
        sample_saliency(model, make_schedule(), pc.from_fields(sampling),
                        pc.from_fields(data_cfg), tb["rgb"], tb.get("audio"))
    pecfg = pc.from_fields(ecfg)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        make_train_step(model, make_schedule(), pecfg)(
            make_optimizer(model, pecfg.optim, 4, 2), tb, torch.Generator().manual_seed(0))


# ----------------------------------------------- path_launches, counted ---

def _count_wrappers(monkeypatch):
    """Count the calls of every wrapper that launches a kernel on the card
    (its plain route here), under chip_smoke's kernel names."""
    from diff_sal_tpu_torch.ops import attention, layernorm, mlp, pool, resize

    calls = {}
    names = {"layer_norm": (layernorm, "layer_norm_fwd"),
             "layer_norm_bwd": (layernorm, "layer_norm_bwd"),
             "block_tail": (mlp, "block_tail"),
             "bilinear_resize_sum": (resize, "bilinear_resize_sum_fwd"),
             "bilinear_resize_add": (resize, "bilinear_resize_add_fwd"),
             "resize_conv_relu": (resize, "resize_sum_conv_relu"),
             "resize_phase_head": (resize, "resize_sum_conv_relu_phase"),
             "bias_attention": (attention, "bias_attention_fwd"),
             "bias_attention_bwd": (attention, "bias_attention_bwd"),
             "fused_bias_attention": (attention, "fused_bias_attention_fwd"),
             "fused_bias_attention_bwd": (attention, "fused_bias_attention_bwd"),
             "cvt_attention": (attention, "cvt_cross_attention"),
             "depthwise_pool3d": (pool, "depthwise_pool3d")}
    for kernel, (mod, fn_name) in names.items():
        fn = getattr(mod, fn_name)

        def counted(*a, _fn=fn, _k=kernel, **kw):
            calls[_k] = calls.get(_k, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, fn_name, counted)
    return calls, set(names)


@pytest.mark.parametrize("mode", ["no_cls", "no_cls_remat", "decoder_only", "audio_visual"])
def test_path_launches_counts_the_new_structures(monkeypatch, mode):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    if mode.startswith("no_cls"):
        cfg = pc.ModelConfig(visual=pc.MViTConfig.dryrun(spatial_size=SMALL, with_cls_token=False,
                                                         remat=mode.endswith("remat")),
                             decoder=pc.SalUNetConfig(img_size=SMALL))
    else:
        audio = mode == "audio_visual"
        cfg = pc.ModelConfig(visual=None, audio=pc.VGGishConfig() if audio else None,
                             spatiotemp=pc.AudioAttnConfig() if audio else None,
                             decoder=pc.SalUNetConfig(img_size=SMALL))
    calls, counted = _count_wrappers(monkeypatch)
    g = torch.Generator().manual_seed(200)
    rgb = torch.randn(1, 16, *SMALL, 3, generator=g)
    audio = (torch.randn(1, 9, SMALL[0] // 2, SMALL[1] // 2, 1, generator=g)
             if cfg.audio is not None else None)
    x = torch.randn(1, *SMALL, 1, generator=g)
    t = torch.tensor([500.0])

    def check(got, want, what):
        assert set(want) >= counted, set(counted) - set(want)
        assert {k: got.get(k, 0) for k in counted} == {k: want[k] for k in counted}, what
        assert all(want[k] == 0 for k in set(want) - counted), what

    model = build_model(cfg, seed=201, device="cpu")
    pg = torch.Generator().manual_seed(202)
    with torch.no_grad():
        if cfg.visual is not None:
            sample_saliency(model, make_schedule(), pc.SamplingConfig(),
                            pc.DataTransformConfig(), rgb, noise=x)
        else:  # the DDIM NFE 1 run with a generator for the pyramid
            feats = model.encode_visual(rgb, pg)
            audio_feat = model.encode_audio(audio) if audio is not None else None
            model.denoise(x, t, feats, audio_feat)
    check(calls, chip_smoke.path_launches(cfg, 1), "eval")
    calls.clear()
    model.train()
    data = {"rgb": rgb, "input": x}
    if audio is not None:
        data["audio"] = audio
    out = model(data, t, train=True, generator=torch.Generator().manual_seed(203),
                pyramid_generator=pg)
    ((out - x) ** 2).mean().backward()
    check(calls, chip_smoke.path_launches(cfg, train=True), "train")
