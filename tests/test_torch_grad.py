"""The port's backward passes (kernels K5 and K6, K4's plain backward, the
autograd Functions around K1, K2 and K4) against the JAX package's
gradients, on the CPU.

Inputs and output cotangents are drawn with numpy from fixed seeds and fed
to both sides; the JAX gradient is `jax.vjp` through the JAX function,
which reaches the Pallas backward bodies in interpret mode where the test
asks for them (`_attn_v2_bwd_kernel` through `fused_bias_attention_v2(...,
interpret=True)`, `_ln_bwd_kernel` through `fused_layernorm(...,
interpret=True)`). Tolerances: f32 on both sides, same arithmetic in
another order; attention gradients sum Lq * Lk products of O(1) terms, so
2e-5; LayerNorm 1e-5. Gradient checks run the autograd Functions in f64
against finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu.ops import attention as j_attn
from diff_sal_tpu.ops import layernorm as j_ln
from diff_sal_tpu.ops import resize as j_resize
from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import layernorm as t_ln
from diff_sal_tpu_torch.ops import mlp as t_mlp
from diff_sal_tpu_torch.ops import resize as t_resize


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _attn_inputs(rng, B, Lq, H, D, k_shape):
    kt, kh, kw = k_shape
    Lk = 1 + kt * kh * kw
    return (_rand(rng, B, Lq, H * D), _rand(rng, B, Lk, H * D), _rand(rng, B, Lk, H * D),
            _rand(rng, B, Lq, H, kt + kh + kw, scale=0.5), _rand(rng, B, Lq, H * D))


def _jax_rel(rel, kp):
    B, Lq, H, Kr = rel.shape
    return np.pad(rel, ((0, 0), (0, 0), (0, 0), (0, kp - Kr))).reshape(B, Lq, H * kp)


def _port_attn_grads(q, k, v, rel, g, k_shape, H, scale, residual):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, rel)]
    out = t_attn.bias_attention(*ts, k_shape, H, scale, residual)
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in ts]


# ---------------------------------------------------------------- K5 ------


@pytest.mark.parametrize("residual", [True, False])
def test_attention_bwd_plain_matches_pallas_bwd_interpret(residual):
    """The TPU backward kernel itself (interpret mode, D=128 and the
    128-lane rel layout it requires); Lq = 100 and Lk = 1 + 3*3*5 = 46 are
    ragged against its tiles."""
    rng = np.random.RandomState(21)
    k_shape, H, D = (3, 3, 5), 2, 128
    q, k, v, rel, g = _attn_inputs(rng, 1, 100, H, D, k_shape)
    scale = D ** -0.5

    def f(q, k, v, r):
        return j_attn.fused_bias_attention_v2(q, k, v, r, k_shape, H, scale, True, residual)

    out_j, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, _jax_rel(rel, 128))))
    dq, dk, dv, drel = vjp(jnp.asarray(g))
    drel = np.asarray(drel).reshape(1, 100, H, 128)[..., :sum(k_shape)]
    out, grads = _port_attn_grads(q, k, v, rel, g, k_shape, H, scale, residual)
    _close(out, out_j, 2e-5)
    for port, ref in zip(grads, (dq, dk, dv, drel)):
        _close(port, ref, 2e-5)


@pytest.mark.parametrize("residual", [True, False])
def test_attention_bwd_plain_matches_reference_autodiff(residual):
    """head_dim 96 as in MViT, against jax's autodiff of the plain
    reference; Lk = 1 + 2*3*4 = 25."""
    rng = np.random.RandomState(22)
    k_shape, H, D = (2, 3, 4), 2, 96
    q, k, v, rel, g = _attn_inputs(rng, 2, 40, H, D, k_shape)
    scale = D ** -0.5

    def f(q, k, v, r):
        return j_attn.reference_bias_attention_v2(q, k, v, r, k_shape, H, scale,
                                                  residual=residual)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, _jax_rel(rel, 128))))
    dq, dk, dv, drel = vjp(jnp.asarray(g))
    drel = np.asarray(drel).reshape(2, 40, H, 128)[..., :sum(k_shape)]
    _, grads = _port_attn_grads(q, k, v, rel, g, k_shape, H, scale, residual)
    for port, ref in zip(grads, (dq, dk, dv, drel)):
        _close(port, ref, 2e-5)


@pytest.mark.parametrize("residual", [True, False])
def test_attention_autograd_gradcheck(residual):
    g = torch.Generator().manual_seed(23)
    k_shape, H = (1, 2, 2), 2
    args = [torch.randn(s, generator=g, dtype=torch.float64).requires_grad_()
            for s in ((1, 5, 8), (1, 5, 8), (1, 5, 8), (1, 5, 2, 5))]
    assert torch.autograd.gradcheck(
        lambda *a: t_attn.bias_attention(*a, k_shape, H, 0.3, residual), args)


def test_attention_bwd_splits_fill_the_card():
    """K5's k-major grid at the MViT train shapes (B=4): every shape gets at
    least two waves of 132 SMs or one split per query tile."""
    for Lq, Lk, H in [(43008, 673, 1), (10752, 2689, 2), (10752, 673, 2), (2688, 2689, 4),
                      (2688, 673, 4), (672, 2689, 8), (672, 673, 8)]:
        s = t_attn.bwd_splits(4, H, Lq, Lk)
        ctas = 4 * H * -(-Lk // 64) * s
        assert ctas >= t_attn.BWD_TARGET_CTAS or s == -(-Lq // 64), (Lq, Lk, H, s)
        assert 1 <= s <= -(-Lq // 64)


# ---------------------------------------------------------------- K6 ------


@pytest.mark.parametrize("C", [96, 192, 512])
@pytest.mark.parametrize("real_dim", [None, "lt"])
def test_layer_norm_bwd_plain_matches_pallas_bwd_interpret(C, real_dim):
    """jax's vjp of fused_layernorm(interpret=True) runs `_ln_bwd_kernel`;
    with real_dim < C the input is zero-padded and the parameters have the
    real length, and the pad lanes of dx carry the mean coupling."""
    rng = np.random.RandomState(C + (real_dim is None))
    rd = None if real_dim is None else C - 32
    n = rd or C
    x = _rand(rng, 3, 24, C, scale=2.0) + 1.0
    if rd:
        x[..., rd:] = 0.0
    w, b, g = _rand(rng, n) + 1.0, _rand(rng, n), _rand(rng, 3, 24, C)

    def f(x, w, b):
        return j_ln.fused_layernorm(x, w, b, 1e-6, True, rd)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, b)))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    t_ln.layer_norm(*ts, 1e-6, rd).backward(torch.from_numpy(g))
    for t, ref in zip(ts, refs):
        assert t.grad.shape == ref.shape
        _close(t.grad, ref, 1e-5)
    if rd:
        assert float(ts[0].grad[..., rd:].abs().max()) > 0  # the coupling is there


@pytest.mark.parametrize("real_dim", [None, 6])
def test_layer_norm_autograd_gradcheck(real_dim):
    g = torch.Generator().manual_seed(24)
    n = real_dim or 8
    x = torch.randn(6, 8, generator=g, dtype=torch.float64)
    if real_dim:
        x[:, real_dim:] = 0.0
    args = [x.requires_grad_()] + [torch.randn(n, generator=g, dtype=torch.float64)
                                   .requires_grad_() for _ in range(2)]
    assert torch.autograd.gradcheck(lambda *a: t_ln.layer_norm(*a, 1e-6, real_dim), args)


def test_layer_norm_bwd_ctas():
    """K6's persistent CTAs: one for a few rows, one per tile up to two per
    SM (tests/test_torch_ln_bwd_plan.py checks the plan in full)."""
    assert t_ln.ln_bwd_plan(1, 96, torch.bfloat16).grid == 1
    assert t_ln.ln_bwd_plan(17 * 64, 96, torch.bfloat16).grid == 17
    assert t_ln.ln_bwd_plan(10 ** 6, 96, torch.bfloat16).grid == t_ln.BWD_MAX_GRID


# ---------------------------------------------------------------- K4 ------


def test_resize_sum_bwd_matches_jax_op_bwd():
    """jax.vjp of bilinear_resize_sum(interpret='force') runs its custom
    vjp `op_bwd` (C a multiple of 128, H of 8)."""
    rng = np.random.RandomState(25)
    shapes = [(7, 12), (14, 24), (28, 48)]
    xs = [_rand(rng, 2, h, w, 128) for h, w in shapes]
    g = _rand(rng, 2, 56, 96, 128)
    _, vjp = jax.vjp(lambda *a: j_resize.bilinear_resize_sum(list(a), (56, 96), "force"),
                     *map(jnp.asarray, xs))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    t_resize.bilinear_resize_sum(ts, (56, 96)).backward(torch.from_numpy(g))
    for t, ref in zip(ts, refs):
        _close(t.grad, ref, 1e-5)


def test_resize_sum_autograd_gradcheck():
    g = torch.Generator().manual_seed(26)
    xs = [torch.randn(s, generator=g, dtype=torch.float64).requires_grad_()
          for s in ((1, 3, 4, 2), (1, 2, 5, 2))]
    assert torch.autograd.gradcheck(lambda *a: t_resize.bilinear_resize_sum(list(a), (6, 7)),
                                    xs)


# ------------------------------------------------------- K3 and routing ----


def _tail_args(requires_grad):
    g = torch.Generator().manual_seed(27)
    shapes = [(4, 16), (4, 16), (16,), (16,), (32, 16), (32,), (16, 32), (16,)]
    return [torch.randn(s, generator=g).requires_grad_(requires_grad) for s in shapes]


def test_block_tail_raises_under_grad_and_runs_without():
    with pytest.raises(RuntimeError, match="eval-only"):
        t_mlp.block_tail(*_tail_args(True))
    with torch.no_grad():
        out = t_mlp.block_tail(*_tail_args(True))
    assert out.grad_fn is None
    assert t_mlp.block_tail(*_tail_args(False)).shape == (4, 16)


def test_cpu_backward_takes_the_plain_route():
    """A CPU backward through K1, K2 and K4 launches no kernel and loads no
    library; each result has a grad_fn."""
    K.reset_launch_counts()
    rng = np.random.RandomState(28)
    t = lambda *s: torch.from_numpy(_rand(rng, *s)).requires_grad_()  # noqa: E731
    outs = [t_ln.layer_norm(t(4, 32), t(32), t(32)),
            t_resize.bilinear_resize_sum([t(1, 2, 3, 8)], (4, 6)),
            t_attn.bias_attention(t(1, 4, 16), t(1, 5, 16), t(1, 5, 16), t(1, 4, 1, 5),
                                  (1, 2, 2), 1, 0.25)]
    assert all(o.grad_fn is not None for o in outs)
    sum(o.sum() for o in outs).backward()
    assert K.launch_counts() == {n: 0 for n in K.registry()}
    assert all(k._fn is None for k in K.registry().values())
