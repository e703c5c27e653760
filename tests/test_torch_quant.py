"""The port's int8 MLP quantisation (`ops/quant.py`, `Mlp(quant=)`,
`MViTConfig.mlp_quant`) against the JAX package's, on the CPU.

- `quantize_kernel`: int8 values and scales bit for bit, the zero column
  included.
- `QuantLinear` against JAX's `QuantDense` on the same int8 weights and
  scales, f32: "w8" within 1e-6 relative (the same f32 sums in another
  order), "w8a8" within 1e-6 relative (the row quantisation bit for bit,
  the int32 products exact on both sides).
- `quantize_state_dict` over the bridged fp state_dict against JAX's
  `quantize_like` over the flax tree, carried across by the bridge: int8
  equal, scales bit-equal, every other entry equal; a mismatched tree
  raises.
- The tiny MViT (`MViTConfig.tiny(spatial_size=(32, 48))`) with `mlp_quant`
  "w8" and "w8a8": the port against JAX on the same quantised weights
  within 1e-5 (f32, every pyramid scale, of max(1, max|x|)), "w8a8" with
  JAX's int8 activation rows pinned (`PinnedRows`: the port's own differ
  by one only where the unrounded value lies within 1e-3 of k + 0.5, and
  in under 0.1% of the elements), and each unpinned within
  tests/test_quant.py's 0.08 (max|d| / max|x|) of the fp model; the cls
  rows through the quantised MLP with the spatial rows (one product) give
  what each gets alone.
"""

import dataclasses
import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu.ops import quant as jq
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.models.layers import Mlp
from diff_sal_tpu_torch.models.mvit import MViT
from diff_sal_tpu_torch.ops import quant as tq
from test_torch_models import random_variables


def test_quantize_kernel_is_the_jax_packages_bit_for_bit():
    w = np.random.RandomState(0).randn(64, 48).astype(np.float32) * 0.1
    w[:, 5] = 0.0  # a zero column takes scale 1
    w[3, 7] = 1e-3  # a column of one small value
    q, s = tq.quantize_kernel(w)
    jq_, js = jq.quantize_kernel(w)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (48,)
    assert np.array_equal(q, jq_) and np.array_equal(s.view(np.int32), js.view(np.int32))
    assert s[5] == 1.0 and not q[:, 5].any()
    # a 3-D kernel: the last axis is the output, as in JAX
    w3 = np.random.RandomState(1).randn(3, 4, 8).astype(np.float32)
    for a, b in zip(tq.quantize_kernel(w3), jq.quantize_kernel(w3)):
        assert np.array_equal(a, b)


def _quant_dense(mode, cout, x, seed=0):
    """JAX's QuantDense on quantize_like's int8 weights from a random fp
    Dense; returns (its output, its params)."""
    fp = flax_nn.Dense(cout)
    fp_params = fp.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    qd = jq.QuantDense(cout, mode=mode)
    q_params = jq.quantize_like(fp_params, qd.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    q_params = jax.tree_util.tree_map(np.asarray, q_params)
    q_params["params"]["bias"] = np.random.RandomState(seed).randn(cout).astype(np.float32)
    return np.asarray(qd.apply(q_params, jnp.asarray(x))), q_params["params"]


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quant_linear_matches_quant_dense(mode):
    x = np.random.RandomState(2).randn(3, 40, 96).astype(np.float32)
    ref, p = _quant_dense(mode, 128, x)
    lin = tq.QuantLinear(96, 128, mode)
    lin.load_state_dict({"weight_q": torch.from_numpy(p["kernel_q"].T.copy()),
                         "weight_scale": torch.from_numpy(p["kernel_scale"]),
                         "bias": torch.from_numpy(p["bias"])})
    got = lin(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 40, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))
    if mode == "w8a8":
        q, s = tq._quant_rows(torch.from_numpy(x))
        jq_, js = jq._quant_rows(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(jq_))
        assert np.array_equal(s.numpy(), np.asarray(js))


def test_quant_linear_rows_are_independent_and_modes_are_checked():
    """Row quantisation and the product are per row: any split of the rows
    gives the same output. The CPU's exact int8 product takes any shape
    (the card's rule is tested in tests/test_torch_cuda.py); an unknown
    mode raises, and a quantised Mlp refuses train mode."""
    lin = tq.QuantLinear(24, 16, "w8a8")
    g = torch.Generator().manual_seed(0)
    lin.weight_q.copy_(torch.randint(-127, 128, (16, 24), generator=g, dtype=torch.int8))
    lin.weight_scale.uniform_(0.01, 0.02, generator=g)
    x = torch.randn(2, 9, 24, generator=g)
    whole = lin(x)
    assert torch.equal(torch.cat([lin(x[:, :1]), lin(x[:, 1:])], 1), whole)
    a = torch.randint(-127, 128, (3, 5), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (4, 5), dtype=torch.int8, generator=g)
    assert torch.equal(tq.int_mm(a, b), (a.long() @ b.long().t()).int())
    with pytest.raises(ValueError):
        tq.QuantLinear(4, 4, "w4")
    with pytest.raises(ValueError):
        Mlp(8, 16, quant="w8")(torch.zeros(1, 8), train=True)


@functools.lru_cache(maxsize=None)
def _mvit_case(mode):
    """JAX's tiny MViT with mlp_quant on quantize_like's tree of random fp
    variables, and the port's fp state_dict bridged from the same fp
    variables."""
    base = jc.MViTConfig.tiny(spatial_size=(32, 48))
    cfg_q = dataclasses.replace(base, mlp_quant=mode)
    x = np.random.RandomState(1).randn(2, 16, 32, 48, 3).astype(np.float32)
    fp_vars = random_variables(jax.eval_shape(JMViT(base).init, jax.random.PRNGKey(0), x), 2)
    jm_q = JMViT(cfg_q)
    q_vars = jq.quantize_like(fp_vars, jax.eval_shape(jm_q.init, jax.random.PRNGKey(0), x))
    fp_sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             bridge.export_mvit(fp_vars["params"], base.num_layers).items()}
    return base, cfg_q, x, jm_q, q_vars, fp_sd


def test_quantize_state_dict_is_quantize_like_through_the_bridge():
    base, cfg_q, x, jm_q, q_vars, fp_sd = _mvit_case("w8a8")
    port_q = MViT(pc.from_fields(cfg_q)).eval()
    sd = tq.quantize_state_dict(fp_sd, port_q.state_dict())
    ref = {k: np.asarray(v) for k, v in
           bridge.export_mvit(q_vars["params"], base.num_layers).items()}
    assert set(sd) == set(ref) == set(port_q.state_dict())
    n_q = 0
    for k, v in sd.items():
        r = ref[k]
        assert v.dtype == torch.from_numpy(r).dtype and tuple(v.shape) == r.shape, k
        assert np.array_equal(v.numpy().view(np.uint8), np.ascontiguousarray(r).view(np.uint8)), k
        n_q += k.endswith(".weight_q")
    assert n_q == 2 * base.num_layers  # fc1 and fc2 of every block
    port_q.load_state_dict(sd, strict=True)
    bad = dict(fp_sd)
    bad.pop("blocks.0.mlp.fc1.weight")
    with pytest.raises(ValueError):
        tq.quantize_state_dict(bad, port_q.state_dict())
    extra = dict(fp_sd, **{"blocks.0.extra": torch.zeros(1)})
    with pytest.raises(ValueError):
        tq.quantize_state_dict(extra, port_q.state_dict())
    shape = dict(fp_sd, **{"cls_token": torch.zeros(1, 1, 7)})
    with pytest.raises(ValueError):
        tq.quantize_state_dict(shape, port_q.state_dict())


def _jax_forward_with_quant_inputs(jm_q, q_vars, x):
    """JAX's quantised MViT output and the input of every QuantDense call,
    in call order (per block: fc1 and fc2 on the spatial rows, then on the
    cls rows)."""
    def run(v, x):
        seen = []

        def grab(next_fun, args, kwargs, context):
            if isinstance(context.module, jq.QuantDense) and context.method_name == "__call__":
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with flax_nn.intercept_methods(grab):
            out = jm_q.apply(v, x)
        return out, seen

    out, seen = jax.jit(run)(q_vars, x)
    return [np.asarray(o) for o in out], [np.asarray(a) for a in seen]


def _joint_rows(seen, n_blocks):
    """The rows of each of the port's MLP products (cls row then the
    spatial rows, per batch item) from JAX's per-call inputs."""
    joint = []
    for i in range(n_blocks):
        for j in range(2):  # fc1, fc2
            sp, cls = seen[4 * i + j], seen[4 * i + 2 + j]
            B, C = cls.shape[0], cls.shape[-1]
            joint.append(np.concatenate([cls.reshape(B, 1, C), sp.reshape(B, -1, C)], 1)
                         .reshape(-1, C))
    return joint


class PinnedRows:
    """Hands the port's `_quant_rows` JAX's int8 rows and scales, call by
    call. w8a8 rounds x * 127 / absmax(row) to an integer, so where the
    two packages' f32 activations (~1e-6 apart) straddle a k + 0.5 the
    int8 values differ by one and the outputs by a quantisation step; as
    with the ReLU branches of tests/test_torch_train_step.py, the test
    pins JAX's and checks that the port's own differ only there."""

    def __init__(self, joint):
        self.pins = [jq._quant_rows(jnp.asarray(r)) for r in joint]
        self.own = tq._quant_rows
        self.flips = self.elements = 0

    def __call__(self, x2):
        q, s = self.own(x2)
        jq_, js = (torch.from_numpy(np.asarray(a)) for a in self.pins.pop(0))
        assert q.shape == jq_.shape and s.shape == js.shape
        np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-5)
        flip = q != jq_
        v = x2.double() / s.double()  # the unrounded value
        assert bool(((v[flip] - v[flip].floor() - 0.5).abs() < 1e-3).all())
        assert bool(((q.int() - jq_.int()).abs() <= 1).all())
        self.flips += int(flip.sum())
        self.elements += q.numel()
        return jq_, js


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_tiny_mvit_matches_jax(mode, monkeypatch):
    base, cfg_q, x, jm_q, q_vars, fp_sd = _mvit_case(mode)
    ref, seen = _jax_forward_with_quant_inputs(jm_q, q_vars, x)
    assert len(seen) == 4 * base.num_layers
    port_fp = MViT(pc.from_fields(base)).eval()
    port_fp.load_state_dict(fp_sd, strict=True)
    port_q = MViT(pc.from_fields(cfg_q)).eval()
    port_q.load_state_dict(tq.quantize_state_dict(fp_sd, port_q.state_dict()), strict=True)
    with torch.no_grad():
        own = port_q(torch.from_numpy(x))
        out_fp = port_fp(torch.from_numpy(x))
        pinned = None
        if mode == "w8a8":
            pinned = PinnedRows(_joint_rows(seen, base.num_layers))
            monkeypatch.setattr(tq, "_quant_rows", pinned)
            out = port_q(torch.from_numpy(x))
            monkeypatch.undo()
            assert not pinned.pins and pinned.flips < 1e-3 * pinned.elements, (
                pinned.flips, pinned.elements)
        else:
            out = own
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, o_own, r, f in zip(out, own, ref, out_fp):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5 * max(1.0, float(np.abs(r).max())),
                                   rtol=0)
        # unpinned, the port's own quantisation: tests/test_quant.py's bound
        d = float((o_own - f).abs().max()) / float(f.abs().max())
        assert 0.0 < d < 0.08, d
    # the cls rows joined to the spatial rows in one product, against each
    # on its own: w8a8 bit for bit (per-row int8, exact int32 sums), w8 to
    # f32 rounding (the f32 sums' order follows the row count)
    blk = port_q.blocks[1]
    g = torch.Generator().manual_seed(3)
    sp = torch.randn(2, 7, blk.mlp.fc1.in_features, generator=g)
    cls = torch.randn(2, 1, blk.mlp.fc1.in_features, generator=g)
    with torch.no_grad():
        joint = blk.mlp(torch.cat([cls, sp], 1))
        apart = torch.cat([blk.mlp(cls), blk.mlp(sp)], 1)
    if mode == "w8a8":
        assert torch.equal(joint, apart)
    else:
        torch.testing.assert_close(joint, apart, rtol=1e-6, atol=1e-6)
