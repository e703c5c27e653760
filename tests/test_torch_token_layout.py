"""MViT's token-concat layout in the port (`MViTConfig.cls_stream=False`)
and its kernels' plain versions, against the JAX package on the CPU.

K12 (`fused_bias_attention`, cls at row 0 of q, k and v per head, three f32
bias terms) and its backward are held against the Pallas bodies in
interpret mode and their custom VJP, f32, at the shapes of
tests/test_pallas_attention.py:154 (BH 2, D 32, q grid (4, 8, 8), k grid
(4, 2, 2), 64-row q tiles so the grid has several steps): 1e-5, the same
f32 function summed in another order. K10 (`bilinear_resize_add`) and its
gradients against the Pallas body in interpret mode at C = 128 and
against the jnp fallback at a C the JAX kernel refuses: 1e-5.

The tiny MViT (`MViTConfig.tiny(spatial_size=(32, 48))`) with
`cls_stream=False` against JAX's with `cls_stream=False,
use_pallas_attention=True` (K12 in interpret mode), the same variables
through `bridge.py`: 1e-4 on the pyramid, as tests/test_torch_models.py
holds the default layout. The port's two layouts against each other in
f64: one function, so the pyramid and every parameter gradient agree to
1e-10 of the largest value (the key-side LayerNorm bias, whose gradient a
softmax makes zero, lands at ~1e-15 in both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu.ops import attention as j_attn
from diff_sal_tpu.ops import resize as j_resize
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.models.mvit import MViT
from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import pool as t_pool
from diff_sal_tpu_torch.ops import resize as t_resize
from test_torch_models import random_variables

F32 = dict(atol=1e-5, rtol=0)


def _k12_inputs(seed, dtype=np.float32, D=32, q_grid=(4, 8, 8), k_shape=(4, 2, 2)):
    rng = np.random.RandomState(seed)
    BH = 2
    Lq, Lk = 1 + int(np.prod(q_grid)), 1 + int(np.prod(k_shape))
    q, k, v, g = (rng.randn(BH, n, D).astype(np.float32) for n in (Lq, Lk, Lk, Lq))
    rels = []
    for n in k_shape:
        r = (rng.randn(BH, Lq, n) * 0.1).astype(np.float32)
        r[:, 0] = 0  # the cls row
        rels.append(r)
    return [q.astype(dtype), k.astype(dtype), v.astype(dtype)], rels, g.astype(dtype), k_shape


@pytest.mark.parametrize("residual", [True, False])
def test_k12_plain_forward_and_backward_match_pallas(residual):
    (q, k, v), rels, g, k_shape = _k12_inputs(7)
    scale = 0.2

    def f(*args):
        out = j_attn.fused_bias_attention(*args, k_shape, scale, 64, True, residual)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref), jgrads = jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, (q, k, v, *rels)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, *rels)]
    out = t_attn.fused_bias_attention(*ts, k_shape, scale, residual)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F32)
    out.backward(torch.from_numpy(g))
    names = ("dq", "dk", "dv", "drel_t", "drel_h", "drel_w")
    for name, t, r in zip(names, ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **F32, err_msg=name)
    # the backward's plain version on its own gives the same six
    plain = t_attn.fused_bias_attention_bwd_plain(*(t.detach() for t in ts),
                                                  torch.from_numpy(g), k_shape, scale, residual)
    for name, a, r in zip(names, plain, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **F32, err_msg=name)


def test_k12_bf16_dtype_contract():
    """bf16 q, k, v get bf16 gradients and the f32 bias terms f32 ones, as
    the JAX custom VJP returns them (tests/test_pallas_attention.py:192);
    the forward returns q's dtype."""
    (q, k, v), rels, g, k_shape = _k12_inputs(8, D=32, q_grid=(2, 4, 4), k_shape=(2, 2, 2))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jr = [jnp.asarray(r) for r in rels]

    def f(*args):
        return jnp.sum(j_attn.fused_bias_attention(*args, k_shape, 0.2, 64, True, True)
                       .astype(jnp.float32))

    jgrads = jax.grad(f, argnums=tuple(range(6)))(jq, jk, jv, *jr)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v)]
    ts += [torch.from_numpy(r).requires_grad_() for r in rels]
    out = t_attn.fused_bias_attention(*ts, k_shape, 0.2, True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    for t, r in zip(ts, jgrads):
        assert str(t.grad.dtype).split(".")[-1] == str(r.dtype), (t.grad.dtype, r.dtype)
        assert t.grad.shape == tuple(r.shape)


def _k10_inputs(seed, C):
    rng = np.random.RandomState(seed)
    acc = rng.randn(2, 16, 24, C).astype(np.float32)
    x = rng.randn(2, 7, 12, C).astype(np.float32)
    g = rng.randn(2, 16, 24, C).astype(np.float32)
    return acc, x, g


@pytest.mark.parametrize("C,interpret", [(128, "force"), (96, None)])
def test_k10_plain_and_gradients_match_jax(C, interpret):
    """C = 128 through the Pallas body in interpret mode; C = 96, which the
    JAX kernel refuses (C % 128), through its jnp fallback."""
    acc, x, g = _k10_inputs(C, C)

    def f(a, b):
        out = j_resize.bilinear_resize_add(a, b, interpret=interpret)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref), (ja, jx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(acc), jnp.asarray(x))
    ta, tx = (torch.from_numpy(a).requires_grad_() for a in (acc, x))
    out = t_resize.bilinear_resize_add(ta, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(t_resize.bilinear_resize_add_plain(ta, tx).detach().numpy(),
                               np.asarray(ref), **F32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **F32)
    assert torch.equal(ta.detach(), torch.from_numpy(acc))  # acc is not written


def test_k10_rounds_the_resized_map_to_acc_dtype():
    """bf16 acc, f32 x: the resized map is rounded to bf16 and then added
    in bf16, as the TPU body rounds (resize.py:139)."""
    acc, x, _ = _k10_inputs(3, 16)
    a = torch.from_numpy(acc).to(torch.bfloat16)
    out = t_resize.bilinear_resize_add(a, torch.from_numpy(x))
    r = t_resize.bilinear_resize(torch.from_numpy(x), (16, 24)).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, a + r)


def _tiny_cfg(**kw):
    return jc.MViTConfig.tiny(spatial_size=(32, 48), **kw)


def test_tiny_mvit_token_concat_matches_jax_k12():
    cfg = _tiny_cfg(cls_stream=False, use_pallas_attention=True)
    x = np.random.RandomState(21).randn(2, 16, 32, 48, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 22)
    ref = jax.jit(jm.apply)(variables, x)
    pcfg = pc.from_fields(cfg)
    assert not pcfg.cls_stream
    pm = MViT(pcfg).eval()
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                        bridge.export_mvit(variables["params"], cfg.num_layers).items()},
                       strict=True)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_both_layouts_share_one_parameter_tree_and_one_bridge():
    """JAX's two layouts init the same variable tree
    (tests/test_mvit.py:136-147), so one bridge conversion loads the port's
    MViT in either layout."""
    x = jnp.zeros((1, 16, 32, 48, 3))
    trees = [jax.eval_shape(JMViT(_tiny_cfg(cls_stream=c)).init, jax.random.PRNGKey(0), x)
             for c in (True, False)]
    assert jax.tree.map(lambda a: a.shape, trees[0]) == jax.tree.map(lambda a: a.shape, trees[1])
    sd = bridge.export_mvit(random_variables(trees[1], 23)["params"], 10)
    for cls_stream in (True, False):
        pm = MViT(pc.from_fields(_tiny_cfg(cls_stream=cls_stream)))
        pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()}, strict=True)


def _f64_pair(**kw):
    cfg = pc.MViTConfig.tiny(spatial_size=(32, 48), **kw)
    a = MViT(cfg).double()
    g = torch.Generator().manual_seed(24)
    with torch.no_grad():
        for name, p in a.named_parameters():
            r = torch.randn(p.shape, generator=g, dtype=torch.float64)
            norm_scale = p.dim() == 1 and name.endswith("weight")
            p.copy_(1.0 + 0.05 * r if norm_scale else 0.1 * r)
    b = MViT(dataclasses.replace(cfg, cls_stream=False)).double()
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("residual_pooling", [True, False])
def test_port_layouts_agree_in_f64(residual_pooling):
    stream, concat = _f64_pair(residual_pooling=residual_pooling)
    x = torch.randn(2, 16, 32, 48, 3, generator=torch.Generator().manual_seed(25),
                    dtype=torch.float64)
    outs = [m(x) for m in (stream, concat)]
    top = max(float(o.detach().abs().max()) for o in outs[0])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-10 * top, rtol=0)
    w = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i), dtype=torch.float64)
         for i, o in enumerate(outs[0])]
    for o in outs:
        sum((a * b).sum() for a, b in zip(o, w)).backward()
    ref = dict(stream.named_parameters())
    top = max(float(p.grad.abs().max()) for p in ref.values() if p.grad is not None)
    n = 0
    for name, p in concat.named_parameters():
        assert (p.grad is None) == (ref[name].grad is None), name
        if p.grad is not None:
            torch.testing.assert_close(p.grad, ref[name].grad, atol=1e-10 * top, rtol=0,
                                       msg=name)
            n += 1
    assert n > 100


def test_from_fields_keeps_the_layout():
    jcfg = dataclasses.replace(jc.ModelConfig.visual_only(),
                               visual=_tiny_cfg(cls_stream=False, pool_mode="pallas"))
    pcfg = pc.from_fields(jcfg)
    assert pcfg.visual == pc.MViTConfig.tiny(spatial_size=(32, 48), cls_stream=False,
                                             pool_mode="pallas")
    assert pc.from_fields(jc.MViTConfig()).cls_stream is True
    assert pc.MViTConfig().cls_stream == jc.MViTConfig().cls_stream


@pytest.mark.parametrize("cls_stream", [True, False])
def test_launch_routing_follows_the_layout(monkeypatch, cls_stream):
    """Each MViT block's attention goes through K12 under cls_stream=False
    and K1 otherwise, forward and backward; the token-concat layout pools
    by convolution even with pool_mode="pallas" (K11 untouched), as JAX
    does. On the CPU the wrappers take the plain route, so the test counts
    the wrapper calls."""
    calls = {}
    for mod, names in ((t_attn, ("bias_attention_fwd", "bias_attention_bwd",
                                 "fused_bias_attention_fwd", "fused_bias_attention_bwd")),
                       (t_pool, ("depthwise_pool3d",))):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, counted)
    cfg = pc.MViTConfig.tiny(spatial_size=(32, 48), cls_stream=cls_stream, pool_mode="pallas")
    m = MViT(cfg)
    x = torch.randn(1, 16, 32, 48, 3, generator=torch.Generator().manual_seed(26))
    sum(o.sum() for o in m(x)).backward()
    L = cfg.num_layers
    k12 = (0, 0) if cls_stream else (L, L)
    k1 = (L, L) if cls_stream else (0, 0)
    assert (calls.get("fused_bias_attention_fwd", 0), calls.get("fused_bias_attention_bwd", 0)) \
        == k12, calls
    assert (calls.get("bias_attention_fwd", 0), calls.get("bias_attention_bwd", 0)) == k1, calls
    assert (calls.get("depthwise_pool3d", 0) > 0) == cls_stream, calls
