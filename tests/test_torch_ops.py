"""The port's operators (diff_sal_tpu_torch.ops) against the JAX package's,
on the CPU in f32, plus the routing and import rules of the port.

Inputs are drawn with numpy from fixed seeds and fed to both sides. Where
the JAX function is a Pallas kernel it runs as the JAX package's own tests
run it: in interpret mode or through its plain reference. Tolerances: the
two sides compute the same f32 arithmetic in a different order, so single
ops agree to max|d| <= 1e-5 (2e-5 where a softmax or a 2C-wide matmul
sums many terms of O(1) values).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu.ops import attention as j_attn
from diff_sal_tpu.ops import layernorm as j_ln
from diff_sal_tpu.ops import mlp as j_mlp
from diff_sal_tpu.ops import rel_pos as j_rel
from diff_sal_tpu.ops import resize as j_resize
from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import layernorm as t_ln
from diff_sal_tpu_torch.ops import mlp as t_mlp
from diff_sal_tpu_torch.ops import pool as t_pool
from diff_sal_tpu_torch.ops import rel_pos as t_rel
from diff_sal_tpu_torch.ops import resize as t_resize

REPO = pathlib.Path(__file__).resolve().parent.parent


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


# ---------------------------------------------------------------- K1 ------


def _attn_inputs(rng, B, Lq, H, D, k_shape):
    kt, kh, kw = k_shape
    Lk = 1 + kt * kh * kw
    q = _rand(rng, B, Lq, H * D)
    k = _rand(rng, B, Lk, H * D)
    v = _rand(rng, B, Lk, H * D)
    rel = _rand(rng, B, Lq, H, kt + kh + kw, scale=0.5)
    return q, k, v, rel


def _jax_rel(rel, kp):
    """(B, Lq, H, K) -> the JAX package's per-head 128-lane layout (B, Lq, H*Kp)."""
    B, Lq, H, Kr = rel.shape
    return np.pad(rel, ((0, 0), (0, 0), (0, 0), (0, kp - Kr))).reshape(B, Lq, H * kp)


@pytest.mark.parametrize("residual", [True, False])
def test_bias_attention_plain_matches_reference_v2(residual):
    """head_dim 96 as in MViT; Lk = 1 + 2*3*4 = 25 is not a tile multiple."""
    rng = np.random.RandomState(0)
    k_shape = (2, 3, 4)
    q, k, v, rel = _attn_inputs(rng, 2, 40, 2, 96, k_shape)
    scale = 96 ** -0.5
    ref = j_attn.reference_bias_attention_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_jax_rel(rel, 128)),
        k_shape, 2, scale, residual=residual)
    out = t_attn.bias_attention(*map(torch.from_numpy, (q, k, v, rel)), k_shape, 2,
                                scale, residual)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("residual", [True, False])
def test_bias_attention_plain_matches_pallas_interpret(residual):
    """The TPU kernel itself (interpret mode, D=128 as it requires);
    Lq = 100 and Lk = 1 + 3*3*5 = 46 are ragged against its tiles."""
    rng = np.random.RandomState(1)
    k_shape = (3, 3, 5)
    q, k, v, rel = _attn_inputs(rng, 1, 100, 2, 128, k_shape)
    scale = 128 ** -0.5
    ref = j_attn.fused_bias_attention_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_jax_rel(rel, 128)),
        k_shape, 2, scale, True, residual)
    out = t_attn.bias_attention(*map(torch.from_numpy, (q, k, v, rel)), k_shape, 2,
                                scale, residual)
    _close(out, ref, 2e-5)


# ---------------------------------------------------------------- K2 ------


@pytest.mark.parametrize("C", [96, 192, 512])
@pytest.mark.parametrize("interpret", [None, True])
def test_layer_norm_matches_fused_layernorm(C, interpret):
    """interpret=None is the JAX reference math, True the Pallas kernel."""
    rng = np.random.RandomState(C)
    x = _rand(rng, 4, 24, C, scale=2.0) + 1.0
    w, b = _rand(rng, C) + 1.0, _rand(rng, C)
    ref = j_ln.fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6, interpret)
    out = t_ln.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6)
    _close(out, ref, 1e-5)


def test_layer_norm_real_dim_matches_fused_layernorm():
    """96 real channels zero-padded to 128, params at the real length."""
    rng = np.random.RandomState(3)
    x = np.pad(_rand(rng, 64, 96), ((0, 0), (0, 32)))
    w, b = _rand(rng, 96) + 1.0, _rand(rng, 96)
    for interpret in (None, True):
        ref = j_ln.fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6,
                                   interpret, 96)
        out = t_ln.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6, real_dim=96)
        _close(out, ref, 1e-5)
        assert float(out[:, 96:].abs().max()) == 0.0


# ---------------------------------------------------------------- K3 ------


@pytest.mark.parametrize("act", ["tanh", "exact"])
@pytest.mark.parametrize("R,C", [(40, 96), (24, 192)])
def test_block_tail_matches_fused_block_tail(act, R, C):
    """Decoder widths with hidden 2C; R not a multiple of the kernel's row
    tile. Against the Pallas kernel (interpret) and its reference."""
    rng = np.random.RandomState(R + C)
    Hd = 2 * C
    skip, attn = _rand(rng, R, C), _rand(rng, R, C)
    lw, lb = _rand(rng, C) + 1.0, _rand(rng, C, scale=0.1)
    w1, b1 = _rand(rng, C, Hd, scale=C ** -0.5), _rand(rng, Hd, scale=0.1)
    w2, b2 = _rand(rng, Hd, C, scale=Hd ** -0.5), _rand(rng, C, scale=0.1)
    j_args = [jnp.asarray(a) for a in (skip, attn, lw, lb, w1, b1, w2, b2)]
    out = t_mlp.block_tail(*map(torch.from_numpy, (skip, attn, lw, lb)),
                           torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
                           torch.from_numpy(w2.T.copy()), torch.from_numpy(b2), 1e-6, act)
    ref_k = j_mlp.fused_block_tail(*j_args, 1e-6, act, True)
    ref_r = j_mlp.block_tail_reference(*j_args, 1e-6, act)
    _close(out, ref_k, 2e-5)
    _close(out, ref_r, 2e-5)


# ---------------------------------------------------------------- K4 ------


def test_resize_sum_matches_bilinear_resize_sum():
    """The decoder's four scales (x16, x8, x4, x2 onto 112x192)."""
    rng = np.random.RandomState(4)
    shapes = [(7, 12), (14, 24), (28, 48), (56, 96)]
    xs = [_rand(rng, 2, h, w, 16) for h, w in shapes]
    ref = j_resize.bilinear_resize_sum([jnp.asarray(x) for x in xs], (112, 192))
    out = t_resize.bilinear_resize_sum([torch.from_numpy(x) for x in xs], (112, 192))
    _close(out, ref, 1e-5)
    for x in xs:  # each scale alone against the single resize
        ref1 = j_resize.bilinear_resize(jnp.asarray(x), (112, 192))
        out1 = t_resize.bilinear_resize_sum([torch.from_numpy(x)], (112, 192))
        _close(out1, ref1, 1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 12), (14, 24)), ((32, 48), (64, 96)),
                                          ((64, 96), (32, 48)), ((5, 7), (11, 3))])
def test_bilinear_resize_matches_jax(in_hw, out_hw):
    rng = np.random.RandomState(5)
    x = _rand(rng, 2, 3, *in_hw, 8)
    _close(t_resize.bilinear_resize(torch.from_numpy(x), out_hw),
           j_resize.bilinear_resize(jnp.asarray(x), out_hw), 1e-5)


def test_linear_resize_and_nearest_match_jax():
    rng = np.random.RandomState(6)
    x = _rand(rng, 4, 9, 5)
    _close(t_resize.linear_resize_1d(torch.from_numpy(x), 13, axis=1),
           j_resize.linear_resize_1d(jnp.asarray(x), 13, axis=1), 1e-6)
    y = _rand(rng, 2, 3, 4, 6, 5)
    _close(t_resize.nearest_upsample(torch.from_numpy(y), 3, h_axis=2, w_axis=3),
           j_resize.nearest_upsample(jnp.asarray(y), 3, h_axis=2, w_axis=3), 0)


# ------------------------------------------------------------ rel-pos -----


@pytest.mark.parametrize("L,q,k", [(111, 56, 7), (15, 8, 8), (55, 14, 28), (27, 7, 14)])
def test_resize_rel_pos_matches_jax(L, q, k):
    table = _rand(np.random.RandomState(L), L, 16)
    _close(t_rel.resize_rel_pos(torch.from_numpy(table), q, k),
           j_rel.resize_rel_pos(jnp.asarray(table), q, k), 1e-6)


def test_add_decomposed_rel_pos_matches_jax():
    rng = np.random.RandomState(7)
    q_shape, k_shape = (2, 4, 6), (2, 2, 3)
    Lq, Lk = 1 + 2 * 4 * 6, 1 + 2 * 2 * 3
    attn, q = _rand(rng, 2, 2, Lq, Lk), _rand(rng, 2, 2, Lq, 8)
    tables = [_rand(rng, 3, 8), _rand(rng, 11, 8), _rand(rng, 11, 8)]
    ref = j_rel.add_decomposed_rel_pos(jnp.asarray(attn), jnp.asarray(q), q_shape, k_shape,
                                       *map(jnp.asarray, tables))
    out = t_rel.add_decomposed_rel_pos(torch.from_numpy(attn), torch.from_numpy(q),
                                       q_shape, k_shape, *map(torch.from_numpy, tables))
    _close(out, ref, 1e-5)


# ------------------------------------------------------------ routing -----


def _cpu_calls():
    rng = np.random.RandomState(8)
    t = lambda *s: torch.from_numpy(_rand(rng, *s))  # noqa: E731
    t_ln.layer_norm(t(4, 32), t(32), t(32))
    t_resize.bilinear_resize_sum([t(1, 2, 3, 8)], (4, 6))
    t_mlp.block_tail(t(4, 16), t(4, 16), t(16), t(16), t(64, 16), t(64), t(16, 64), t(16))
    t_attn.bias_attention(t(1, 4, 16), t(1, 5, 16), t(1, 5, 16), t(1, 4, 1, 5),
                          (1, 2, 2), 1, 0.25)
    t_attn.cvt_cross_attention(t(1, 6, 16), t(1, 2, 16), t(1, 2, 16), 2, 0.25)
    t_pool.depthwise_pool3d(t(1, 2, 3, 4, 8), t(3, 3, 3, 8), (1, 2, 2))
    t_resize.resize_sum_conv_relu([t(1, 2, 3, 16)], (4, 6), t(3, 3, 16, 16), t(16))
    t_resize.resize_sum_conv_relu_phase([t(1, 2, 3, 16)], (4, 6), t(3, 3, 16, 8), t(8))
    q = t(2, 5, 16).requires_grad_()
    t_attn.fused_bias_attention(q, t(2, 5, 16), t(2, 5, 16), t(2, 5, 1), t(2, 5, 2), t(2, 5, 2),
                                (1, 2, 2), 0.25, True).sum().backward()
    t_resize.bilinear_resize_add(t(1, 4, 6, 8), t(1, 2, 3, 8).requires_grad_()).sum().backward()


def test_cpu_tensors_take_the_plain_route():
    """CPU calls never load a kernel library and launch nothing."""
    K.reset_launch_counts()
    _cpu_calls()
    assert K.launch_counts() == {n: 0 for n in K.registry()}
    assert all(k._fn is None for k in K.registry().values())


def test_other_devices_raise():
    m = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError):
        t_ln.layer_norm(m, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError):
        t_resize.bilinear_resize_sum([torch.empty(1, 2, 3, 8, device="meta")], (4, 6))
    with pytest.raises(ValueError):
        t_pool.depthwise_pool3d(torch.empty(1, 2, 3, 4, 8, device="meta"),
                                torch.empty(3, 3, 3, 8, device="meta"), (1, 1, 1))
    with pytest.raises(ValueError):
        t_attn.cvt_cross_attention(*(torch.empty(1, n, 16, device="meta") for n in (4, 2, 2)),
                                   2, 0.25)
    with pytest.raises(ValueError):
        t_attn.fused_bias_attention(*(torch.empty(1, 5, 16, device="meta") for _ in range(3)),
                                    *(torch.empty(1, 5, n, device="meta") for n in (1, 2, 2)),
                                    (1, 2, 2), 0.25)
    with pytest.raises(ValueError):
        t_resize.bilinear_resize_add(torch.empty(1, 4, 6, 8, device="meta"),
                                     torch.empty(1, 2, 3, 8, device="meta"))
    xs, k = [torch.empty(1, 2, 3, 16, device="meta")], torch.empty(3, 3, 16, 16, device="meta")
    for head in (t_resize.resize_sum_conv_relu, t_resize.resize_sum_conv_relu_phase):
        with pytest.raises(ValueError):
            head(xs, (4, 6), k, torch.empty(16, device="meta"))


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    def no_nvcc():
        raise K.KernelBuildError("nvcc not found")

    monkeypatch.setattr(K, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(K, "_nvcc", no_nvcc)
    kern = K.Kernel("layernorm", "layernorm.cu", "dsal_layernorm", [], replaces="")
    with pytest.raises(K.KernelBuildError):
        kern.fn()
    with pytest.raises(K.KernelBuildError):
        kern.launch()
    assert kern.launches == 0


def test_model_is_built_on_the_card_unless_the_caller_asks_for_the_cpu():
    from diff_sal_tpu_torch.config import ModelConfig, MViTConfig
    from diff_sal_tpu_torch.models.diff_model import build_model

    cfg = ModelConfig(visual=MViTConfig.tiny(spatial_size=(32, 48)))
    model = build_model(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"} and not model.training
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:  # no silent CPU fallback
        with pytest.raises((AssertionError, RuntimeError)):
            build_model(cfg)


def test_every_kernel_has_a_source_and_names_its_tpu_kernel():
    for kern in K.registry().values():
        assert kern.source_path.exists(), kern.source
        text = kern.source_path.read_text()
        sig = re.search(r'extern "C" int ' + kern.entry + r"\(([^)]*)\)", text)
        assert sig, kern.entry
        assert len(sig.group(1).split(",")) == len(kern.argtypes), kern.name
        where, func = kern.replaces.split()[:2]
        path, line = where.split(":")
        src = (REPO / path).read_text()
        assert src.splitlines()[int(line) - 1].startswith(f"def {func}(")
        assert "pl.pallas_call(" in src


def test_port_imports_nothing_of_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|diff_sal_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "diff_sal_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if f.exists() and pat.search(f.read_text())]
    assert not offenders, offenders
    assert len(files) > 10
