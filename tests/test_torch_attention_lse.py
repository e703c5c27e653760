"""The forward's saved logsumexp and the wrappers' dtype routing, on the CPU.

K1's and K12's forward kernels write each query row's logsumexp of the
biased scores; the autograd Functions save it and hand it to the backward
kernels, which recompute p = exp(s - lse) instead of a logsumexp pass. On
the CPU the plain forward returns the same quantity from the plain scores,
so one autograd Function serves both devices. The wrappers route by q's
dtype on the card: bf16 to the Hopper kernels, f32 to their f32 instances,
anything else raises. Here the card route is driven on meta tensors with
the launches recorded instead of run."""

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import mlp as t_mlp

K_SHAPE = (2, 3, 4)
LK = 1 + 2 * 3 * 4


def _k1_inputs(dtype, B=2, Lq=37, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)  # noqa: E731
    return t(B, Lq, H * D), t(B, LK, H * D), t(B, LK, H * D), t(B, Lq, H, sum(K_SHAPE)) * 0.5


def _k12_inputs(dtype, BH=3, Lq=38, D=64, seed=1):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    rels = [t(BH, Lq, n) * 0.5 for n in K_SHAPE]
    for r in rels:
        r[:, 0] = 0
    return t(BH, Lq, D).to(dtype), t(BH, LK, D).to(dtype), t(BH, LK, D).to(dtype), rels


def _k1_scores(q, k, rel, H, scale):
    """The biased scores, written out independently of the port: (B, H, Lq, Lk) f64."""
    B, Lq, HD = q.shape
    D = HD // H
    qs = (q * torch.tensor(scale, dtype=q.dtype)).double().reshape(B, Lq, H, D)
    s = torch.einsum("blhd,bkhd->bhlk", qs, k.double().reshape(B, LK, H, D))
    r = rel.double()
    kt, kh, kw = K_SHAPE
    for j in range(1, LK):
        t_, rem = divmod(j - 1, kh * kw)
        h_, w_ = divmod(rem, kw)
        s[..., j] += (r[..., t_] + r[..., kt + h_] + r[..., kt + kh + w_]).permute(0, 2, 1)
    return s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("residual", [True, False])
def test_k1_plain_lse_is_the_logsumexp_of_the_scores(dtype, residual):
    q, k, v, rel = _k1_inputs(dtype)
    scale = 64 ** -0.5
    out, lse = t_attn.bias_attention_plain(q, k, v, rel, K_SHAPE, 2, scale, residual,
                                           return_lse=True)
    assert lse.shape == (2, 2, 37) and lse.dtype == K.acc_dtype(dtype)
    ref = torch.logsumexp(_k1_scores(q, k, rel, 2, scale), dim=-1)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(lse.double(), ref, atol=tol, rtol=tol)
    torch.testing.assert_close(out, t_attn.bias_attention_plain(q, k, v, rel, K_SHAPE, 2, scale,
                                                                residual), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k12_plain_lse_is_the_logsumexp_of_the_scores(dtype):
    q, k, v, rels = _k12_inputs(dtype)
    scale = 64 ** -0.5
    _, lse = t_attn.fused_bias_attention_plain(q, k, v, *rels, K_SHAPE, scale, True,
                                               return_lse=True)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).double()
    s = torch.einsum("bld,bkd->blk", qs, k.double())
    rt, rh, rw = (r.double() for r in rels)
    bias = (rt[..., :, None, None] + rh[..., None, :, None] + rw[..., None, None, :])
    s[..., 1:] += bias.reshape(*bias.shape[:2], -1)
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1), atol=2e-5, rtol=2e-5)


def test_autograd_saves_the_lse_and_gives_the_plain_gradients():
    """K1's Function saves the forward's logsumexp (only when a gradient
    will be taken) and its backward equals the plain backward."""
    q, k, v, rel = _k1_inputs(torch.float64)
    ins = [t.clone().requires_grad_() for t in (q, k, v, rel)]
    out = t_attn.bias_attention(*ins, K_SHAPE, 2, 0.125, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    _, lse = t_attn.bias_attention_plain(q, k, v, rel, K_SHAPE, 2, 0.125, True, return_lse=True)
    torch.testing.assert_close(saved[4], lse, atol=0, rtol=0)
    g = torch.randn(out.shape, dtype=out.dtype, generator=torch.Generator().manual_seed(3))
    out.backward(g)
    ref = t_attn.bias_attention_bwd_plain(q, k, v, rel, g, K_SHAPE, 2, 0.125, True)
    for t, r in zip(ins, ref):
        torch.testing.assert_close(t.grad, r, atol=1e-12, rtol=1e-12)
    with torch.no_grad():
        assert t_attn.bias_attention(q, k, v, rel, K_SHAPE, 2, 0.125, True).grad_fn is None


def test_k12_autograd_saves_the_lse():
    q, k, v, rels = _k12_inputs(torch.float64)
    ins = [t.clone().requires_grad_() for t in (q, k, v, *rels)]
    out = t_attn.fused_bias_attention(*ins, K_SHAPE, 0.125, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[6].shape == (3, 38)
    out.sum().backward()
    ref = t_attn.fused_bias_attention_bwd_plain(q, k, v, *rels, torch.ones_like(q), K_SHAPE,
                                                0.125, True)
    for t, r in zip(ins, ref):
        torch.testing.assert_close(t.grad, r, atol=1e-12, rtol=1e-12)


# -------------------------------------------------------- dtype routing ---


@pytest.fixture
def card_route(monkeypatch):
    """The card route on meta tensors: no device check, no stream, and each
    launch recorded by kernel name instead of run."""
    launched = []
    monkeypatch.setattr(K, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(K, "stream", lambda: 0)
    monkeypatch.setattr(K.Kernel, "launch", lambda self, *a: launched.append((self.name, a)))
    return launched


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,fwd,bwd", [
    (torch.bfloat16, "bias_attention", "bias_attention_bwd"),
    (torch.float32, "bias_attention_f32", "bias_attention_bwd_f32")])
def test_k1_routes_by_dtype(card_route, dtype, fwd, bwd):
    q, k, rel = _meta(2, 37, 128, dtype=dtype), _meta(2, LK, 128, dtype=dtype), \
        _meta(2, 37, 2, 9, dtype=dtype)
    out, lse = t_attn.bias_attention_fwd(q, k, k, rel, K_SHAPE, 2, 0.125, True, return_lse=True)
    assert out.dtype == dtype and lse.shape == (2, 2, 37) and lse.dtype == torch.float32
    grads = t_attn.bias_attention_bwd(q, k, k, rel, q, K_SHAPE, 2, 0.125, True, lse=lse)
    assert [t.dtype for t in grads] == [dtype] * 4
    names = [n for n, _ in card_route]
    assert names == [fwd, bwd]
    kern = K.registry()
    for name, args in card_route:
        assert len(args) == len(kern[name].argtypes), name


@pytest.mark.parametrize("dtype,fwd,bwd", [
    (torch.bfloat16, "fused_bias_attention", "fused_bias_attention_bwd"),
    (torch.float32, "fused_bias_attention_f32", "fused_bias_attention_bwd_f32")])
def test_k12_routes_by_dtype(card_route, dtype, fwd, bwd):
    q, k = _meta(3, 38, 64, dtype=dtype), _meta(3, LK, 64, dtype=dtype)
    rels = [_meta(3, 38, n, dtype=torch.float32) for n in K_SHAPE]
    out, lse = t_attn.fused_bias_attention_fwd(q, k, k, *rels, K_SHAPE, 0.125, True,
                                               return_lse=True)
    assert lse.shape == (3, 38)
    grads = t_attn.fused_bias_attention_bwd(q, k, k, *rels, q, K_SHAPE, 0.125, True, lse=lse)
    assert [t.dtype for t in grads] == [dtype] * 3 + [torch.float32] * 3
    assert [n for n, _ in card_route] == [fwd, bwd]
    kern = K.registry()
    for name, args in card_route:
        assert len(args) == len(kern[name].argtypes), name


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "cvt_attention"),
                                        (torch.float32, "cvt_attention_f32")])
def test_k7_routes_by_dtype(card_route, dtype, name):
    q, k = _meta(2, 50, 96, dtype=dtype), _meta(2, 18, 96, dtype=dtype)
    with torch.no_grad():
        t_attn.cvt_cross_attention(q, k, k, 2, 96 ** -0.5)
    assert [n for n, _ in card_route] == [name]


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "block_tail"),
                                        (torch.float32, "block_tail_f32")])
def test_k3_routes_by_dtype(card_route, dtype, name):
    x = _meta(40, 96, dtype=dtype)
    vec = torch.zeros(96, device="meta")
    with torch.no_grad():
        t_mlp.block_tail(x, x, vec, vec, _meta(192, 96, dtype=dtype), torch.zeros(192, device="meta"),
                         _meta(96, 192, dtype=dtype), vec)
    assert [n for n, _ in card_route] == [name]


def test_the_card_route_refuses_other_dtypes_and_a_missing_lse(card_route):
    h = torch.float16
    q, k, rel = _meta(2, 37, 128, dtype=h), _meta(2, LK, 128, dtype=h), _meta(2, 37, 2, 9, dtype=h)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        t_attn.bias_attention_fwd(q, k, k, rel, K_SHAPE, 2, 0.125)
    rels = [_meta(3, 38, n, dtype=torch.float32) for n in K_SHAPE]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        t_attn.fused_bias_attention_fwd(_meta(3, 38, 64, dtype=h), _meta(3, LK, 64, dtype=h),
                                        _meta(3, LK, 64, dtype=h), *rels, K_SHAPE, 0.125)
    with pytest.raises(ValueError, match="bfloat16 or float32"), torch.no_grad():
        t_attn.cvt_cross_attention(_meta(2, 50, 96, dtype=h), _meta(2, 18, 96, dtype=h),
                                   _meta(2, 18, 96, dtype=h), 2, 0.1)
    with pytest.raises(ValueError), torch.no_grad():
        x = _meta(40, 96, dtype=h)
        t_mlp.block_tail(x, x, torch.zeros(96, device="meta"), torch.zeros(96, device="meta"),
                         _meta(192, 96, dtype=h), torch.zeros(192, device="meta"),
                         _meta(96, 192, dtype=h), torch.zeros(96, device="meta"))
    b = torch.bfloat16
    qb, kb, rb = _meta(2, 37, 128, dtype=b), _meta(2, LK, 128, dtype=b), _meta(2, 37, 2, 9, dtype=b)
    with pytest.raises(ValueError, match="logsumexp"):
        t_attn.bias_attention_bwd(qb, kb, kb, rb, qb, K_SHAPE, 2, 0.125)
    with pytest.raises(ValueError):  # mixed dtypes
        t_attn.bias_attention_fwd(_meta(2, 37, 128, dtype=torch.float32), kb, kb, rb, K_SHAPE,
                                  2, 0.125)
    assert card_route == []
