"""The work arithmetic of ``benchmark/work`` against hand counts."""

from __future__ import annotations

import pytest
import torch

from benchmark.reference.ops import CallLog
from benchmark.work import count
from benchmark.work.kernels import kind
from benchmark.work.peaks import HBM_BYTES_PER_S, PEAK_FLOP_PER_S


def test_conv3x3_bound_by_hand():
    log = CallLog()
    log.conv3x3[(8, 64, 64, 256, 256, True, True)] = 1
    flops = 2 * 8 * 64 * 64 * 256 * 256 * 9
    x = y = 8 * 64 * 64 * 256
    k = 256 * 256 * 9
    fwd = max(flops / 989e12, (x + y + k) * 2 / 3.35e12)
    wgrad = max(flops / 989e12, (x + y) * 2 / 3.35e12 + 4 * k / 3.35e12)
    assert count.conv3x3_bound_s(log, "bfloat16") == pytest.approx(2 * fwd + wgrad, rel=1e-12)


def test_gn_silu_bound_by_hand():
    log = CallLog()
    log.gn_silu[(128, 256, 256, 32, True)] = 2
    log.gn_silu[(128, 32, 32, 128, False)] = 1
    n1, n2 = 128 * 256 * 256 * 32, 128 * 32 * 32 * 128
    want = (2 * (5 * n1) + 2 * n2) * 2 / 3.35e12
    assert count.gn_silu_bound_s(log, "bfloat16") == pytest.approx(want, rel=1e-12)


def test_attention_bound_by_hand():
    log = CallLog()
    log.attention[(8, 4096, 256, True)] = 1
    fwd = 4 * 8 * 4096 * 4096 * 256
    assert fwd == 137438953472  # 137.4 GFLOP
    want = fwd / 989e12 + 2.5 * fwd / 989e12  # both bound by operations at this size
    assert count.flash_bound_s(log, "bfloat16") == pytest.approx(want, rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert PEAK_FLOP_PER_S["bfloat16"] == 989e12 and HBM_BYTES_PER_S == 3.35e12


def test_flop_counter_counts_one_convolution_and_its_backward():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.ops import Ops

    x = torch.empty((2, 16, 8, 8), device="meta", requires_grad=True)
    w = torch.empty((32, 16, 3, 3), device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as c:
        Ops().conv(x, w, None, padding=1).sum().backward()
    one = 2 * 2 * 8 * 8 * 16 * 32 * 9
    assert c.get_total_flops() == 3 * one  # forward, input and filter gradients


def test_call_log_of_a_training_step_counts_each_kernel_call():
    ae = {"spatial_dims": 2, "in_channels": 1, "out_channels": 1, "latent_channels": 4,
          "channels": [8, 16], "num_res_blocks": 1, "norm_num_groups": 4,
          "attention_levels": [False, False]}
    from benchmark.reference.train import Objective

    _, log = count.train_step(ae, Objective(kl_weight=1e-3, perceptual_weight=1.0), 4, (32, 32))
    # (2 levels x 1 ResBlock + 2 mid ResBlocks) x 2 norms + norm_out, in each coder (42 at
    # the flagship's widths, the launches the program makes)
    assert sum(log.gn_silu.values()) == 9 + 9 and all(k[-1] for k in log.gn_silu)
    assert sum(log.attention.values()) == 2
    # conv_in takes no input gradient; every other 3x3 stride-1 convolution does
    assert sum(v for k, v in log.conv3x3.items() if not k[5]) == 1


@pytest.mark.parametrize("name,want", [
    ("groupnorm_silu_fwd_kernel", "hand"), ("flash_bwd_wide_kernel", "hand"),
    ("conv3x3_wgrad_wgmma_kernel", "hand"), ("sm90_xmma_fprop_implicit_gemm", "library"),
    ("nvjet_tst_128x64", "library"), ("void at::native::vectorized_elementwise_kernel", "glue"),
    ("void at::native::reduce_kernel<512, 1>", "glue"),
    ("Memcpy HtoD (Pageable -> Device)", "glue"),
])
def test_kernel_classes(name, want):
    assert kind(name) == want
