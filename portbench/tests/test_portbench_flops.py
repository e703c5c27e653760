"""The operation count against hand counts."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import flops, spec
from portbench.reference import model as ref_model


def _count(fn):
    mode = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: flops.conv_backward})
    with mode:
        fn()
    return mode.get_total_flops()


def test_audio_attention_matches_a_hand_count():
    c = ref_model.ns({"dim": 512, "depth": 1, "heads": 2, "dim_head": 64, "mlp_dim": 256,
                      "dropout": 0.0})
    with torch.device("meta"):
        net = ref_model.AudioAttnNet(c).requires_grad_(False)
    B, T, H, W = 3, 9, 7, 12
    N = T * H * W
    x = torch.empty((B, T, H, W, 512), device="meta")
    got = _count(lambda: net(x))
    inner = 2 * 64
    hand = B * (2 * N * 512 * 3 * inner      # qkv
                + 2 * 2 * N * N * inner      # q k^T and p v over both heads
                + 2 * N * inner * 512        # out projection
                + 2 * 2 * N * 512 * 256)     # feed-forward
    assert got == hand


def test_convolution_backward_counts_each_gradient_as_the_forward():
    x = torch.empty((2, 96, 8, 14, 24), device="meta", requires_grad=True)
    for w_shape, groups in (((96, 1, 3, 3, 3), 96), ((64, 96, 3, 3, 3), 1)):
        w = torch.empty(w_shape, device="meta", requires_grad=True)
        out_numel = 2 * w_shape[0] * 8 * 14 * 24
        forward = 2 * out_numel * w_shape[1] * 27
        y = None

        def fwd():
            nonlocal y
            y = F.conv3d(x, w, None, 1, 1, 1, groups)
        assert _count(fwd) == forward
        assert _count(lambda: y.sum().backward()) == 2 * forward


@pytest.mark.parametrize("cut,encoders,denoiser", [(False, 306.9, 158.57), (True, 306.9, 118.0)])
def test_the_cells_counts_match_the_per_clip_work(cut, encoders, denoiser):
    """Encoders once, the denoiser once per call. The published graph runs
    every decoder stage over all 9 frames (158.57 GFLOP a call and clip);
    with the dead-frame cut at every stage (`skip_dead_frames_all`) a
    call does 118.0, the count of the port's default flags by
    `torch.utils.flop_counter` at B=1."""
    av = copy.deepcopy(spec.config("diffsal_av")["model"])
    av["decoder"]["skip_dead_frames_all"] = cut
    ddim = flops.count(av, spec.traffic("ddim_nfe1_b30")) / 30
    dpm = flops.count(av, spec.traffic("dpmpp2m_nfe5_b30")) / 30
    assert abs(ddim / 1e9 - (encoders + denoiser)) < 0.5
    assert abs((dpm - ddim) / 4 / 1e9 - denoiser) < 0.5
