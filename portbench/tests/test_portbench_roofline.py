"""The frozen bounds against `chip_smoke.py:bound_terms`, where they were
copied from."""

import sys
from pathlib import Path

import pytest
import torch

from portbench.core import roofline

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402


def _t(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


CALLS = {
    "bias_attention": (_t(2, 5376, 192), _t(2, 673, 192), _t(2, 673, 192), _t(2, 5376, 2, 27),
                       (8, 7, 12), 2, 0.125, True),
    "bias_attention_bwd": (_t(2, 5376, 192), _t(2, 673, 192), _t(2, 673, 192),
                           _t(2, 5376, 2, 27), _t(2, 5376, 192), (8, 7, 12), 2, 0.125),
    "layer_norm": (_t(2, 43008, 1, 96), _t(96, dtype=torch.float32),
                   _t(96, dtype=torch.float32), 1e-6),
    "layer_norm_bwd": (_t(2, 43008, 96), _t(2, 43008, 96), _t(96, dtype=torch.float32), 1e-6),
    "block_tail": (_t(8064, 384), _t(8064, 384), _t(384, dtype=torch.float32),
                   _t(384, dtype=torch.float32), _t(768, 384), _t(768, dtype=torch.float32),
                   _t(384, 768), _t(384, dtype=torch.float32)),
    "bilinear_resize_sum": ([_t(2, 7, 12, 768), _t(2, 14, 24, 768), _t(2, 28, 48, 768)],
                            (56, 96)),
}


@pytest.mark.parametrize("kernel", sorted(CALLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bound_terms_agree_with_chip_smoke(kernel, dtype):
    args = tuple([a.to(dtype) for a in x] if isinstance(x, list) else
                 x.to(dtype) if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x
                 for x in CALLS[kernel])
    assert roofline.bound_terms(kernel, args) == chip_smoke.bound_terms(kernel, args, {})
    nbytes, ops = roofline.bound_terms(kernel, args)
    assert roofline.bound_seconds(kernel, args) == max(
        nbytes / roofline.HBM_BYTES_PER_S, sum(n / p for n, p in ops))


def test_peaks_are_the_data_sheets():
    assert (roofline.HBM_BYTES_PER_S, roofline.BF16_TENSOR_FLOPS, roofline.F32_FLOPS) == \
        (chip_smoke.HBM_BYTES_PER_S, chip_smoke.BF16_TENSOR_FLOPS, chip_smoke.F32_FLOPS)
