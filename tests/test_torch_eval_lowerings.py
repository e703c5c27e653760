"""The port's eval lowerings against the JAX package's, on the CPU in f32:
kernels K11 (depthwise pool, `MViTConfig.pool_mode="pallas"`), K7 (CvT
cross-attention, `SalUNetConfig.fused_attn`), K8 and K9 (the decoder head
with BatchNorm folded, `ConvBNRelu.fused_head` and
`SalUNetConfig.head_lowres`) and the modules that route to them. The
small AV model with all three flags through DPM-Solver++ 2M is in
tests/test_torch_dpm_solver.py.

Inputs are drawn with numpy from fixed seeds and fed to both sides. The
JAX functions run as the JAX package's own tests run them on the CPU: the
Pallas bodies in interpret mode (`interpret="force"` for the heads), else
their plain fallbacks. Tolerances: single ops agree to max|d| <= 1e-5
(the same f32 arithmetic summed in another order), networks and the
final map to 1e-4, unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.ops import attention as j_attn
from diff_sal_tpu.ops import pool as j_pool
from diff_sal_tpu.ops import resize as j_resize
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import pool as t_pool
from diff_sal_tpu_torch.ops import resize as t_resize


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


# ---------------------------------------------------------------- K11 -----


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)])
def test_depthwise_pool_matches_pallas_interpret(stride):
    """Value and (x, w) gradients of the port's pool (plain forward, conv
    VJP backward) against the Pallas body in interpret mode and jax.grad
    through its custom VJP; C = 128 as the TPU kernel requires, odd H and
    W. The gradient sums up to 27 products per element: 1e-5 of the
    values' O(1) scale for dx, and for dw, which sums B*T*Ho*Wo of them,
    1e-5 of the largest |dw|."""
    rng = np.random.RandomState(sum(stride))
    x = _rand(rng, 2, 3, 9, 11, 128)
    w = _rand(rng, 3, 3, 3, 128, scale=0.3)
    g = _rand(rng, *t_pool.pool_plain(torch.from_numpy(x), torch.from_numpy(w), stride).shape)

    def loss(x_, w_):
        return jnp.sum(j_pool.depthwise_pool3d(x_, w_, stride) * g)

    ref = jax.jit(lambda a, b: j_pool.depthwise_pool3d(a, b, stride))(x, w)
    rdx, rdw = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, w)

    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = t_pool.depthwise_pool3d(xt, wt, stride)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _close(out, ref, 1e-5)
    _close(xt.grad, rdx, 1e-5)
    _close(wt.grad, rdw, 1e-5 * float(np.abs(np.asarray(rdw)).max()))


def test_depthwise_pool_reads_strided_columns_in_place():
    """The pool of a column slice of a wider tensor (MViT pools the q or kv
    columns of the qkv projection) equals the pool of its copy."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(_rand(rng, 1, 2, 5, 7, 48))
    w = torch.from_numpy(_rand(rng, 3, 3, 3, 32))
    a = t_pool.depthwise_pool3d(qkv[..., 16:], w, (1, 2, 2))
    b = t_pool.depthwise_pool3d(qkv[..., 16:].contiguous(), w, (1, 2, 2))
    assert torch.equal(a, b)


# ----------------------------------------------------------------- K7 -----


@pytest.mark.parametrize("S", [18, 1])
@pytest.mark.parametrize("C", [96, 192])
def test_cvt_attention_matches_pallas_interpret(S, C):
    """reference_cvt_attention and cvt_cross_attention (its CPU route)
    against the Pallas body in interpret mode; 2 heads, L = 50 rows, not a
    multiple of the TPU kernel's 8-row tiles; the reference's scale C^-1/2."""
    rng = np.random.RandomState(C + S)
    q, k, v = _rand(rng, 3, 50, C), _rand(rng, 3, S, C), _rand(rng, 3, S, C)
    scale = C ** -0.5
    ref = j_attn.cvt_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, scale,
                                     interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(t_attn.reference_cvt_attention(tq, tk, tv, 2, scale), ref, 1e-5)
    _close(t_attn.cvt_cross_attention(tq, tk, tv, 2, scale), ref, 1e-5)


def test_cvt_attention_is_eval_only():
    q = torch.randn(1, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        t_attn.cvt_cross_attention(q, torch.randn(1, 2, 32), torch.randn(1, 2, 32), 2, 0.2)
    with torch.no_grad():
        assert t_attn.cvt_cross_attention(q, torch.randn(1, 2, 32), torch.randn(1, 2, 32), 2,
                                          0.2).shape == (1, 8, 32)


# ------------------------------------------------------------- K8, K9 -----


def _head_inputs(seed, shapes, C, O):
    rng = np.random.RandomState(seed)
    xs = [_rand(rng, 2, h, w, C, scale=0.5) for h, w in shapes]
    return xs, _rand(rng, 3, 3, C, O, scale=0.05), _rand(rng, O, scale=0.1)


HEAD_CASES = [  # (task shapes, out_hw): the TPU bodies need C % 128 == 0, O <= 128
    ([(2, 3), (4, 6), (8, 12), (16, 24)], (16, 24)),  # K8: H % 8 == 0
    ([(7, 6), (14, 12), (28, 24), (5, 9)], (28, 24)),  # K9: TH % 28 == 0
]


@pytest.mark.parametrize("case", [0, 1])
def test_fused_heads_match_pallas_interpret(case):
    """resize_sum_conv_relu (K8's plain route) against the K8 Pallas body,
    and resize_sum_conv_relu_phase (K9's plain route,
    `resize_sum_conv_relu_lowres`) against the K9 Pallas body and JAX's
    `resize_sum_conv_relu_lowres`, all in f32, C = 128, O = 32. The head
    contracts 9 * 128 products of O(0.03) per output: 1e-5."""
    shapes, out_hw = HEAD_CASES[case]
    xs, k, b = _head_inputs(case, shapes, 128, 32)
    txs = [torch.from_numpy(x) for x in xs]
    tk, tb = torch.from_numpy(k), torch.from_numpy(b)
    jxs = [jnp.asarray(x) for x in xs]
    if case == 0:
        ref = j_resize.resize_sum_conv_relu(jxs, out_hw, jnp.asarray(k), jnp.asarray(b),
                                            interpret="force")
        _close(t_resize.resize_sum_conv_relu(txs, out_hw, tk, tb), ref, 1e-5)
    else:
        ref = j_resize.resize_sum_conv_relu_phase(jxs, out_hw, jnp.asarray(k), jnp.asarray(b),
                                                  interpret="force")
        _close(t_resize.resize_sum_conv_relu_phase(txs, out_hw, tk, tb), ref, 1e-5)
    low = j_resize.resize_sum_conv_relu_lowres(jxs, out_hw, jnp.asarray(k), jnp.asarray(b))
    _close(t_resize.resize_sum_conv_relu_lowres(txs, out_hw, tk, tb), low, 1e-5)
    # the two lowerings are one function
    _close(t_resize.resize_sum_conv_relu_plain(txs, out_hw, tk, tb), low, 1e-5)


def test_fused_heads_are_eval_only():
    xs = [torch.randn(1, 2, 3, 16, requires_grad=True)]
    k, b = torch.randn(3, 3, 16, 8), torch.randn(8)
    for head in (t_resize.resize_sum_conv_relu, t_resize.resize_sum_conv_relu_phase):
        with pytest.raises(RuntimeError, match="eval-only"):
            head(xs, (4, 6), k, b)


@pytest.mark.parametrize("flag", ["head_lowres", "fused_head"])
def test_conv_bn_relu_eval_heads_match_flax(flag):
    """ConvBNRelu at eval with the BatchNorm fold, against flax's ConvBNRelu
    with the same flag, parameters and batch_stats (random, off the init
    defaults so that the fold is exercised)."""
    import flax

    from diff_sal_tpu.models.layers import ConvBNRelu as JConvBNRelu
    from diff_sal_tpu_torch.models.layers import ConvBNRelu

    rng = np.random.RandomState(11)
    C, O, out_hw = 64, 32, (16, 24)
    tasks = [_rand(rng, 2, h, w, C, scale=0.5) for h, w in [(2, 3), (4, 6), (8, 12), (16, 24)]]
    jm = JConvBNRelu(features=O, **{flag: True})
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(0), tasks=tasks, out_hw=out_hw))
    v = jax.tree.map(lambda a: _rand(rng, *a.shape, scale=0.2), v)
    v["batch_stats"]["bn"]["var"] = np.abs(v["batch_stats"]["bn"]["var"]) + 0.5
    ref = jm.apply(v, tasks=tasks, out_hw=out_hw, train=False)

    pm = ConvBNRelu(C, O, **{flag: True}).eval()
    p, s = v["params"], v["batch_stats"]
    pm.load_state_dict({
        "0.weight": torch.from_numpy(np.ascontiguousarray(p["conv"]["kernel"].transpose(3, 2, 0, 1))),
        "0.bias": torch.from_numpy(p["conv"]["bias"]),
        "1.weight": torch.from_numpy(p["bn"]["scale"]), "1.bias": torch.from_numpy(p["bn"]["bias"]),
        "1.running_mean": torch.from_numpy(s["bn"]["mean"]),
        "1.running_var": torch.from_numpy(s["bn"]["var"]),
        "1.num_batches_tracked": torch.tensor(0),
    })
    with torch.no_grad():
        out = pm([torch.from_numpy(t) for t in tasks], out_hw)
        stock = ConvBNRelu(C, O).eval()
        stock.load_state_dict(pm.state_dict())
        unfused = stock([torch.from_numpy(t) for t in tasks], out_hw)
    _close(out, ref, 1e-5)
    _close(out, unfused.numpy(), 1e-5)


def test_decoder_routes_the_flags():
    """`head_lowres` reaches mt_proj, `fused_attn` every CvT attention;
    `fused_head` stays a module field that the Decoder never sets."""
    from diff_sal_tpu_torch.models.sal_unet import SalUNet

    cfg = pc.SalUNetConfig(img_size=(64, 96), fused_attn=True, head_lowres=True)
    dec = SalUNet(cfg, with_audio=True).invpt_decoder
    assert dec.mt_proj.head_lowres and not dec.mt_proj.fused_head
    assert all(s.blocks[0].attn.fused_attn for s in dec.mid_stages)
    assert not SalUNet(pc.SalUNetConfig(), with_audio=False).invpt_decoder.mt_proj.head_lowres


# ------------------------------------------------------------- models -----


def test_mvit_pallas_pools_match_flax():
    """The tiny MViT with pool_mode="pallas" on both sides: the port's K11
    route (plain on the CPU) against the JAX package's Pallas pools in
    interpret mode; the parameter tree is the conv route's."""
    from diff_sal_tpu.models.mvit import MViT as JMViT
    from diff_sal_tpu_torch.models.mvit import MViT
    from test_torch_models import ATOL, random_variables

    cfg = jc.MViTConfig.tiny(spatial_size=(32, 48), pool_mode="pallas")
    x = np.random.RandomState(1).randn(2, 16, 32, 48, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 2)
    ref = jax.jit(jm.apply)(variables, x)
    pm = MViT(pc.from_fields(cfg)).eval()
    assert pm.blocks[0].attn.pool_mode == "pallas"
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                        bridge.export_mvit(variables["params"], cfg.num_layers).items()},
                       strict=True)
    K.reset_launch_counts()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert K.launch_counts()["depthwise_pool3d"] == 0  # the CPU route launches nothing
    for o, r in zip(out, ref):
        _close(o, r, ATOL)
