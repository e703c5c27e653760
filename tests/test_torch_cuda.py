"""The port's four Hopper kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and nvcc: the `cuda` marker
names them and the `card` fixture skips them where
`torch.cuda.is_available()` is false. This file imports no JAX (the card's
machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances compare in the working dtype on the same inputs. In bf16 the
kernel and the plain version round the same f32 values at other points
(the flash softmax, the order of sums), so they may differ by one bf16 ulp
of the output: |d| <= 1e-2 + 1e-2 * |plain| covers one ulp at any
magnitude. In f32 the difference is the order of f32 sums: 1e-5.
"""

import dataclasses

import pytest
import torch

from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import layernorm as t_ln
from diff_sal_tpu_torch.ops import mlp as t_mlp
from diff_sal_tpu_torch.ops import resize as t_resize

pytestmark = pytest.mark.cuda

BF16_TOL = dict(atol=1e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)


def _check(out, plain, dtype):
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), plain.float(), **tol)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("residual", [True, False])
def test_bias_attention_kernel(card, D, residual):
    g = torch.Generator().manual_seed(D)
    k_shape = (8, 7, 12)  # MViT block 0's key grid: Lk = 673
    B, Lq, H = 2, 1000, 2
    Lk = 1 + 8 * 7 * 12
    q, k, v = (_randn(g, B, n, H * D) for n in (Lq, Lk, Lk))
    rel = _randn(g, B, Lq, H, 27, scale=0.5)
    before = t_attn.KERNEL.launches
    out = t_attn.bias_attention(q, k, v, rel, k_shape, H, D ** -0.5, residual)
    assert t_attn.KERNEL.launches == before + 1
    _check(out, t_attn.bias_attention_plain(q, k, v, rel, k_shape, H, D ** -0.5, residual),
           torch.bfloat16)


@pytest.mark.parametrize("C", [96, 192, 384, 512, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel(card, C, dtype):
    g = torch.Generator().manual_seed(C)
    x = _randn(g, 3, 333, C, dtype=dtype, scale=2.0) + 1.0
    w, b = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32)
    _check(t_ln.layer_norm(x, w, b, 1e-6), t_ln.layer_norm_plain(x, w, b, 1e-6), dtype)


def test_layer_norm_kernel_real_dim(card):
    g = torch.Generator().manual_seed(0)
    x = torch.nn.functional.pad(_randn(g, 100, 96, dtype=torch.float32), (0, 32))
    w, b = _randn(g, 96, dtype=torch.float32), _randn(g, 96, dtype=torch.float32)
    out = t_ln.layer_norm(x, w, b, 1e-6, real_dim=96)
    _check(out, t_ln.layer_norm_plain(x, w, b, 1e-6, real_dim=96), torch.float32)
    assert float(out[:, 96:].abs().max()) == 0.0


@pytest.mark.parametrize("C,R", [(768, 840), (384, 3360), (192, 1000), (96, 5000)])
@pytest.mark.parametrize("act", ["tanh", "exact"])
def test_block_tail_kernel(card, C, R, act):
    """The decoder's widths and row counts at B=2 (R ragged against 32)."""
    g = torch.Generator().manual_seed(C + R)
    Hd = 2 * C
    skip, attn = _randn(g, R, C), _randn(g, R, C)
    lw, lb = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32, scale=0.1)
    w1, b1 = _randn(g, Hd, C, scale=C ** -0.5), _randn(g, Hd, dtype=torch.float32, scale=0.1)
    w2, b2 = _randn(g, C, Hd, scale=Hd ** -0.5), _randn(g, C, dtype=torch.float32, scale=0.1)
    args = (skip, attn, lw, lb, w1, b1, w2, b2, 1e-6, act)
    _check(t_mlp.block_tail(*args), t_mlp.block_tail_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 768), (torch.float32, 96)])
def test_resize_sum_kernel(card, dtype, C):
    g = torch.Generator().manual_seed(C)
    xs = [_randn(g, 2, h, w, C, dtype=dtype) for h, w in
          [(7, 12), (14, 24), (28, 48), (56, 96)]]
    _check(t_resize.bilinear_resize_sum(xs, (112, 192)),
           t_resize.bilinear_resize_sum_plain(xs, (112, 192)), dtype)


def test_kernels_refuse_what_they_do_not_take(card):
    g = torch.Generator().manual_seed(1)
    q = _randn(g, 1, 10, 96, dtype=torch.float32)
    k = _randn(g, 1, 5, 96, dtype=torch.float32)
    rel = _randn(g, 1, 10, 1, 5, dtype=torch.float32)
    with pytest.raises(ValueError):  # K1 takes bf16 only
        t_attn.bias_attention(q, k, k, rel, (1, 2, 2), 1, 0.1)
    with pytest.raises(ValueError):  # non-contiguous rows
        t_ln.layer_norm(_randn(g, 8, 64)[:, ::2], torch.ones(32), torch.zeros(32))


def test_small_av_model_on_card_matches_cpu(card):
    """The whole port at the small AV size: bf16 through the kernels on the
    card against f32 through the plain versions on the CPU, same weights
    and noise. bf16 keeps ~3 significant digits, the map lies in [0, 1]:
    max|d| <= 3e-2."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, DataTransformConfig, ModelConfig,
                                           MViTConfig, SalUNetConfig, SamplingConfig,
                                           VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model

    cfg = ModelConfig(visual=MViTConfig.tiny(spatial_size=(64, 96)), audio=VGGishConfig(),
                      spatiotemp=AudioAttnConfig(), decoder=SalUNetConfig(img_size=(64, 96)))
    g = torch.Generator().manual_seed(0)
    rgb, audio = torch.randn(2, 16, 64, 96, 3, generator=g), torch.randn(2, 9, 32, 48, 1, generator=g)
    noise = torch.randn(2, 64, 96, 1, generator=g)
    args = (make_schedule(), SamplingConfig(), DataTransformConfig())
    cpu = build_model(cfg, 3, device="cpu")
    ref = sample_saliency(cpu, *args, rgb, audio, noise=noise)
    gpu = VideoSaliencyModel(dataclasses.replace(cfg, compute_dtype="bfloat16")).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(card)
    K.reset_launch_counts()
    out = sample_saliency(gpu, *args, rgb.to(card), audio.to(card), noise=noise)
    counts = K.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
    assert torch.isfinite(out).all()
    assert float((out.cpu() - ref).abs().max()) <= 3e-2
