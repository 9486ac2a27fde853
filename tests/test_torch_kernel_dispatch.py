"""Host-side pieces of the port's tensor-core kernels, on the CPU: the rules
that pick a kernel by dtype and shape, the tile choice, the zero-padding of
the weight matrix and of thin channel counts, a numpy model of the kernel's
shared-memory layout and descriptor addressing against the plain version,
and the build hash.

The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``).
Bars: the layout model repeats the plain version's f32 arithmetic in another
order of summation, rtol 1e-4 / atol 1e-5.
"""

import shutil

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.conv import pack_weight
from pti_ldm_vae_tpu_torch.ops.kernels import _build
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
    SOURCES as CONV_SOURCES,
    WGMMA_MAX_CIN,
    conv3x3_plain,
    flip_transpose,
    forward_kernel,
    pad_channels,
    pad_columns,
    pad_weight_channels,
    STREAM_TILE,
    stream_smem_bytes,
    streams_weights,
    wgmma_smem_bytes,
    wgmma_tile,
)
from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    SOURCES as FLASH_SOURCES,
    SUPPORTED_HEAD_DIMS,
    _check as flash_check,
    backward_kernel as flash_backward_kernel,
    bwd_fma_smem_bytes,
    bwd_fma_tile,
    forward_kernel as flash_forward_kernel,
    fwd_fma_smem_bytes,
    fwd_fma_tile,
    pad_head_dim,
    padded_head_dim,
)

# (B, H, W, Cin, Cout) of the 47 3x3 convolutions of a flagship pass at 256², batch 8
PATH_SHAPES = [
    (8, 128, 128, 128, 128), (8, 256, 256, 64, 64), (8, 128, 128, 128, 64), (8, 256, 256, 64, 32),
    (8, 256, 256, 32, 32), (8, 128, 128, 64, 64), (8, 64, 64, 128, 128), (8, 128, 128, 32, 64),
    (8, 64, 64, 64, 128), (8, 32, 32, 128, 128), (8, 256, 256, 1, 32), (8, 256, 256, 32, 1),
    (8, 32, 32, 128, 4), (8, 32, 32, 4, 128),
]
# (B, H, W, Cin, Cout) of the 38 3x3 convolutions of a config/ar_vae_dente_kl1e3.json pass
# (64-128-256, 10-channel latent) at 256², batch 8
KL1E3_SHAPES = [
    (8, 128, 128, 256, 256), (8, 256, 256, 128, 128), (8, 128, 128, 256, 128),
    (8, 256, 256, 128, 64), (8, 256, 256, 64, 64), (8, 128, 128, 128, 128), (8, 64, 64, 256, 256),
    (8, 128, 128, 64, 128), (8, 64, 64, 128, 256), (8, 64, 64, 256, 10), (8, 64, 64, 10, 256),
    (8, 256, 256, 1, 64), (8, 256, 256, 64, 1),
]
# (B, H, W, Cin, Cout) of the flagship's space-to-depth forms (s2d_stem) that no standard
# pass has: the encoder's conv_in 1 -> 32 as 4 -> 128 and the decoder's conv_out 32 -> 1 as
# 128 -> 4, at 128² (its 128 -> 128, 256 -> 256 and 256 -> 128 are above)
S2D_SHAPES = [(8, 128, 128, 4, 128), (8, 128, 128, 128, 4)]
RAGGED_THIN = (1, 20, 12, 3, 5)
RAGGED_WGMMA = (2, 37, 70, 24, 40)
N_SM = 132  # an H100
SMEM_MAX = 232448  # what a block may ask for on sm_90


def _kernel_cin(cin):
    """The ``Cin`` the tensor-core kernel sees: padded with zero channels to a multiple of 8."""
    return -(-cin // 8) * 8


def _id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", PATH_SHAPES + KL1E3_SHAPES + [RAGGED_THIN, RAGGED_WGMMA] + S2D_SHAPES,
                         ids=_id)
def test_conv_forward_kernel_rule(shape):
    cin, cout = shape[3], shape[4]
    # f32 never leaves the FMA kernel, as forward or as input gradient
    assert forward_kernel(torch.float32, cin, cout) == "fma"
    assert forward_kernel(torch.float32, cout, cin) == "fma"
    # bf16: a tensor-core kernel at every channel count of the paths, a thin or ragged
    # one through zero channels up to a multiple of 8; the streamed-weight one exactly at the
    # kl1e3 model's Cin 256 calls with Cout >= 64 (the flagship's, s2d's and the ragged shapes
    # have Cin <= 128 throughout)
    calls = ((cin, cout), (cout, cin))
    for (c_in, c_out), streamed in zip(calls, STREAMED.get(shape, (False, False))):
        assert streams_weights(c_in, c_out) == streamed, (c_in, c_out)
        assert forward_kernel(torch.bfloat16, c_in, c_out) == ("wgmma_stream" if streamed else "wgmma")
    # an unaligned base address keeps any shape on the FMA kernel
    assert forward_kernel(torch.bfloat16, cin, cout, aligned=False) == "fma"
    assert forward_kernel(torch.bfloat16, cout, cin, aligned=False) == "fma"


def test_conv_forward_kernel_rule_on_the_path():
    calls = [(s[3], s[4]) for s in PATH_SHAPES + KL1E3_SHAPES]
    forward = [forward_kernel(torch.bfloat16, cin, cout) for cin, cout in calls]
    dgrad = [forward_kernel(torch.bfloat16, cout, cin) for cin, cout in calls]
    # the 1-channel stems, the 4- and 10-channel latents and Cin 256 take the tensor cores too
    assert set(forward) == set(dgrad) == {"wgmma", "wgmma_stream"}
    assert forward_kernel(torch.bfloat16, RAGGED_THIN[3], RAGGED_THIN[4]) == "wgmma"
    assert forward_kernel(torch.bfloat16, RAGGED_WGMMA[3], RAGGED_WGMMA[4]) == "wgmma"
    assert forward_kernel(torch.float16, 32, 32) == "fma"  # (the wrapper refuses the dtype)
    assert forward_kernel(torch.bfloat16, 128, 256) == "wgmma"
    assert forward_kernel(torch.bfloat16, 136, 256) == "wgmma"


@pytest.mark.parametrize("cin", [1, 4, 8, 10, 20, 256, 512, 1000, 1513, WGMMA_MAX_CIN])
def test_conv_forward_kernel_rule_up_to_the_limit(cin):
    """Every bf16 ``Cin`` up to ``WGMMA_MAX_CIN`` takes the tensor cores, the
    next one does not; the limit is the widest ``Cin`` (padded) whose slab
    fits at the narrowest tile, 8 output channels beside a ring of 16."""
    assert forward_kernel(torch.bfloat16, cin, 8) == "wgmma"
    assert forward_kernel(torch.bfloat16, cin, 64) == ("wgmma_stream" if cin > 176 else "wgmma")
    for cout in (8, 64, 256):
        assert forward_kernel(torch.bfloat16, WGMMA_MAX_CIN + 1, cout) == "fma"
        assert forward_kernel(torch.bfloat16, 2048, cout) == "fma"
    assert WGMMA_MAX_CIN % 8 == 0
    assert wgmma_smem_bytes(WGMMA_MAX_CIN, 1, 8, 16) == 231_152 <= SMEM_MAX
    assert wgmma_smem_bytes(WGMMA_MAX_CIN + 8, 1, 8, 16) == 233_456 > SMEM_MAX
    mt, tn, kc = wgmma_tile(8, 32, 32, _kernel_cin(cin), 64, N_SM)
    assert wgmma_smem_bytes(_kernel_cin(cin), mt, tn, kc) <= SMEM_MAX


def _tile_rule_holds(shape):
    b, h, w, cin, cout = shape
    cin = _kernel_cin(cin)
    mt, tn, kc = wgmma_tile(b, h, w, cin, cout, N_SM)
    assert mt in (4, 2, 1) and tn in (8, 16, 32, 64) and kc in (16, 32, 64)
    # no wider than the smallest width that covers Cout, and no narrower than the slab needs
    cover = next((t for t in (8, 16, 32) if cout <= t), 64)
    assert tn <= cover
    assert tn == cover or wgmma_smem_bytes(cin, 1, 2 * tn, 16) > SMEM_MAX
    tiles = b * -(-h // 8) * -(-w // (8 * mt)) * -(-cout // tn)
    wider = b * -(-h // 8) * -(-w // (16 * mt)) * -(-cout // tn)
    assert 2 * tiles >= N_SM or mt == 1  # at least a tile per two SMs
    # and no wider tile that fits would have given that
    assert mt == 4 or 2 * wider < N_SM or wgmma_smem_bytes(cin, 2 * mt, tn, 16) > SMEM_MAX
    assert kc == 16 or kc <= cin  # a step no deeper than the input
    smem = wgmma_smem_bytes(cin, mt, tn, kc)
    assert smem <= SMEM_MAX and (228 * 1024) // (smem + 1024) >= 1  # one block resident at least


@pytest.mark.parametrize("shape", PATH_SHAPES + KL1E3_SHAPES + [RAGGED_WGMMA, RAGGED_THIN] + S2D_SHAPES,
                         ids=_id)
def test_wgmma_tile_covers_the_shape_and_spreads_over_the_card(shape):
    _tile_rule_holds(shape)
    _tile_rule_holds((*shape[:3], shape[4], shape[3]))  # the input gradient's


@pytest.mark.parametrize("cin", [136, 176, 184, 256, 368, 376, 512, 752, 760, 1024, WGMMA_MAX_CIN])
def test_wgmma_tile_narrows_the_block_as_cin_grows(cin):
    for cout in (1, 10, 64, 128, 256, 512):
        _tile_rule_holds((8, 64, 64, cin, cout))
    want_tn = 64 if cin <= 176 else 32 if cin <= 368 else 16 if cin <= 752 else 8
    assert wgmma_tile(8, 64, 64, cin, 512, N_SM)[1] == want_tn


def test_wgmma_tile_at_the_levels_of_the_flagship():
    assert wgmma_tile(8, 256, 256, 32, 32, N_SM) == (4, 32, 32)
    assert wgmma_tile(8, 256, 256, 64, 32, N_SM) == (4, 32, 32)  # 64 deep: one block per SM
    assert wgmma_tile(8, 256, 256, 64, 64, N_SM) == (4, 64, 64)
    assert wgmma_tile(8, 128, 128, 128, 128, N_SM) == (4, 64, 32)  # 64 deep does not fit
    assert wgmma_tile(8, 64, 64, 128, 128, N_SM) == (4, 64, 32)
    assert wgmma_tile(8, 32, 32, 128, 128, N_SM) == (2, 64, 64)  # 128 tiles; 64 with the wider one
    assert wgmma_tile(8, 32, 32, 128, 4, N_SM) == (1, 8, 64)
    assert wgmma_tile(8, 256, 256, 32, 1, N_SM) == (4, 8, 32)
    assert wgmma_tile(1, 8, 8, 8, 8, N_SM) == (1, 8, 16)
    assert wgmma_tile(2, 37, 70, 24, 40, N_SM) == (1, 64, 16)


# every forward and input gradient of a kl1e3 pass: the streamed-weight kernel ("stream") where
# Cin 256 would narrow the resident slab to 32 output columns and Cout is 64 or more, else the
# slab kernel's (mt, tn, kc, bytes); a thin Cin is padded to 8 or 16 first
KL1E3_TILES = {  # (B, H, W, Cin, Cout): forward, input gradient
    (8, 128, 128, 256, 256): ("stream", "stream"),
    (8, 256, 256, 128, 128): ((4, 64, 32, 224_064), (4, 64, 32, 224_064)),
    (8, 128, 128, 256, 128): ("stream", (4, 64, 32, 224_064)),
    (8, 256, 256, 128, 64): ((4, 64, 32, 224_064), (4, 64, 64, 216_576)),
    (8, 256, 256, 64, 64): ((4, 64, 64, 216_576), (4, 64, 64, 216_576)),
    (8, 128, 128, 128, 128): ((4, 64, 32, 224_064), (4, 64, 32, 224_064)),
    (8, 64, 64, 256, 256): ("stream", "stream"),
    (8, 128, 128, 64, 128): ((4, 64, 64, 216_576), (4, 64, 32, 224_064)),
    (8, 64, 64, 128, 256): ((4, 64, 32, 224_064), "stream"),
    (8, 64, 64, 256, 10): ((4, 16, 16, 110_208), (4, 64, 16, 61_920)),
    (8, 64, 64, 10, 256): ((4, 64, 16, 61_920), (4, 16, 16, 110_208)),
    (8, 256, 256, 1, 64): ((4, 64, 16, 61_920), (4, 8, 32, 77_648)),
    (8, 256, 256, 64, 1): ((4, 8, 32, 77_648), (4, 64, 16, 61_920)),
}


# which bf16 calls of a kl1e3 pass stream their weights: (forward, input gradient)
STREAMED = {s: tuple(t == "stream" for t in KL1E3_TILES[s]) for s in KL1E3_SHAPES}


@pytest.mark.parametrize("shape", KL1E3_SHAPES + ["wider"], ids=lambda s: _id(s) if s != "wider" else s)
def test_wgmma_tile_at_the_levels_of_the_kl1e3_model(shape):
    """Every forward and input gradient of a kl1e3 pass, with the bytes each
    block asks for: at ``Cin`` 256 and ``Cout`` >= 64 the call streams its
    weights (the resident slab would narrow the block to 32 output columns:
    148,032 bytes; 64 would need 296,064); at ``Cin`` 256 -> 10 it keeps the
    slab at 16 columns; a thin ``Cin`` is padded to 8 or 16 first."""
    assert sorted(KL1E3_TILES) == sorted(KL1E3_SHAPES)
    if shape == "wider":  # Cin 512 streams too; the slab kernel would take 16 output columns
        assert forward_kernel(torch.bfloat16, 512, 512) == "wgmma_stream"
        assert wgmma_tile(8, 32, 32, 512, 512, N_SM) == (4, 16, 32)
        assert wgmma_smem_bytes(512, 4, 16, 32) == 217_056
        assert forward_kernel(torch.bfloat16, WGMMA_MAX_CIN, 256) == "wgmma_stream"
        assert wgmma_tile(8, 32, 32, WGMMA_MAX_CIN, 256, N_SM) == (1, 8, 16)
        return
    b, h, w, cin, cout = shape
    for (c_in, c_out), want in zip(((cin, cout), (cout, cin)), KL1E3_TILES[shape]):
        route = forward_kernel(torch.bfloat16, c_in, c_out)
        if want == "stream":
            assert route == "wgmma_stream", (shape, c_in, c_out)
            assert stream_smem_bytes() <= SMEM_MAX
            continue
        assert route == "wgmma", (shape, c_in, c_out)
        got = wgmma_tile(b, h, w, _kernel_cin(c_in), c_out, N_SM)
        assert (*got, wgmma_smem_bytes(_kernel_cin(c_in), *got)) == want, (shape, c_in, c_out)
        assert want[3] <= SMEM_MAX


@pytest.mark.parametrize("cin,cout,want", [
    (176, 256, False), (184, 256, True), (177, 64, True), (256, 63, False), (256, 64, True),
    (256, 10, False), (128, 256, False), (WGMMA_MAX_CIN, 64, True), (8, 512, False)])
def test_streams_weights_where_the_slab_would_narrow(cin, cout, want):
    """The rule reads ``(Cin, Cout)`` alone: the padded ``Cin`` above 176,
    where 64 output columns of slab no longer fit beside the smallest ring,
    and ``Cout`` at least 64."""
    assert streams_weights(cin, cout) == want
    cin_k = _kernel_cin(cin)
    assert (wgmma_smem_bytes(cin_k, 1, 64, 16) > SMEM_MAX and cout >= 64) == want
    assert wgmma_tile(8, 64, 64, cin_k, max(cout, 64), N_SM)[1] < 64 or not want


def _stream_constants():
    """The integer constants ``constexpr int kName = N;`` of the streamed-weight kernel's source."""
    import re

    text = (_build.CSRC_DIR / "conv3x3_stream_wgmma.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_stream_smem_bytes_matches_the_kernel_constants():
    """``stream_smem_bytes`` and ``STREAM_TILE`` against the constants of
    ``csrc/conv3x3_stream_wgmma.cu``: alignment slack, 7 weight stages of 64 x
    128 bf16, 2 halo stages of 8 planes of 10 x 34 pixels (5,440 bytes, each
    slot rounded up to 5,504), two 8-byte mbarriers per stage; one block per SM."""
    k = _stream_constants()
    assert STREAM_TILE == (k["kPatches"], k["kTileN"], k["kChunk"])
    assert (k["kHaloStages"], k["kWeightStages"], k["kAlign"]) == (2, 7, 1024)
    plane = -(-10 * (8 * k["kPatches"] + 2) * 16 // 128) * 128
    assert plane == 5504
    want = (k["kAlign"] + k["kWeightStages"] * k["kChunk"] * k["kTileN"] * 2
            + k["kHaloStages"] * (k["kChunk"] // 8) * plane
            + 8 * 2 * (k["kHaloStages"] + k["kWeightStages"]))
    assert stream_smem_bytes() == want == 1024 + 7 * 16_384 + 2 * 44_032 + 144 == 203_920
    assert stream_smem_bytes() <= SMEM_MAX and (228 * 1024) // (stream_smem_bytes() + 1024) == 1
    # a producer warpgroup and two consumer warpgroups; the registers they trade add up
    assert k["kConsumers"] == 2 and (1 + k["kConsumers"]) * 128 == 384
    assert 128 * 40 + 256 * 232 <= 65_536


def test_stream_launches_are_reset_and_split_out():
    from pti_ldm_vae_tpu_torch.ops import kernels

    kernels.conv3x3.stream_launches = 3
    kernels.conv3x3.launches = 5
    assert kernels.split_launch_counts()["conv3x3_stream"] == 3
    assert kernels.launch_counts()["conv3x3"] == 5
    kernels.reset_launch_counts()
    assert kernels.conv3x3.stream_launches == 0 and kernels.split_launch_counts()["conv3x3_stream"] == 0
    # the plain version on CPU tensors launches nothing
    x = torch.zeros(1, 8, 8, 256)
    kernels.conv3x3(x, torch.zeros(9 * 256, 64))
    assert kernels.conv3x3.stream_launches == 0 and kernels.launch_counts()["conv3x3"] == 0


def test_wgmma_smem_bytes_matches_the_kernel_formula():
    # slab 9 * (tn/8) * (16*Cin + 16), three stages of kc/8 padded planes, 64 * (2*tn + 16)
    assert wgmma_smem_bytes(128, 4, 64, 32) == 9 * 8 * 2064 + 3 * 4 * 5520 + 64 * 144
    assert wgmma_smem_bytes(32, 4, 32, 32) == 9 * 4 * 528 + 3 * 4 * 5520 + 64 * 80
    assert wgmma_smem_bytes(24, 1, 64, 16) == 9 * 8 * (32 * 16 + 16) + 3 * 2 * 1680 + 64 * 144
    assert wgmma_smem_bytes(128, 4, 64, 64) > 232448  # the rule must not pick it
    # Cin 256: the slab alone overflows at 64 output channels, fits at 32 (and at 16 up to 512)
    assert 9 * 8 * (256 * 16 + 16) == 296_064 > 232448
    assert wgmma_smem_bytes(256, 4, 32, 32) == 9 * 4 * 4112 + 3 * 4 * 5520 + 64 * 80 == 219_392
    assert wgmma_smem_bytes(256, 4, 32, 16) == 186_272
    assert wgmma_smem_bytes(256, 4, 32, 64) > 232448
    assert wgmma_smem_bytes(512, 4, 16, 32) == 9 * 2 * 8208 + 3 * 4 * 5520 + 64 * 48


@pytest.mark.parametrize("cout", [1, 4, 5, 8, 40, 128])
def test_pad_columns_round_trip(cout):
    cin = 8
    rng = np.random.default_rng(cout)
    weight = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3)).astype(np.float32))
    wmat = pack_weight(weight)
    padded = pad_columns(wmat)
    assert padded.shape == (9 * cin, -(-cout // 8) * 8)
    assert torch.equal(padded[:, :cout], wmat) and not padded[:, cout:].any()
    assert (padded is wmat) == (cout % 8 == 0)
    # the padded columns are extra output channels that stay zero
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, cin)).astype(np.float32))
    y = conv3x3_plain(x, padded)
    torch.testing.assert_close(y[..., :cout], conv3x3_plain(x, wmat), rtol=1e-4, atol=1e-5)
    assert not y[..., cout:].any()
    # the input gradient's matrix pads the same way (its columns are Cin)
    flipped = pad_columns(flip_transpose(pack_weight(weight[:, :5]), 5, cout))
    assert flipped.shape == (9 * cout, 8) and not flipped[:, 5:].any()


def _model_of_the_kernel(x, wmat, mt, tn, kc=16):
    """The tensor-core convolution kernel's data path in numpy, on the
    operands as the kernel receives them (``Cin`` a multiple of 8, the
    matrix's columns padded to a multiple of 8): per tile and chunk of ``kc``
    input channels the halo as ``kc/8`` planes ``[plane][halo row][halo
    column][8]`` (zero outside the image and past ``Cin``), the block's weight
    slab as ``[tap][N-group][rows of whole chunks][8]`` (zero past ``Cin`` and
    past the padded ``Cout``), and per tap and k16 step one product whose A
    rows are read at the descriptor's strides (8 pixels of a halo row; the
    next output row one halo row further; the next 8 channels one plane
    further) from the start moved by (ky, kx), and whose B rows are 16 rows
    of the slab from row ``chunk*kc + 16*kk``."""
    b, h, w, cin = x.shape
    ldw = wmat.shape[1]
    assert cin % 8 == 0 and ldw % 8 == 0
    hc, ng, planes = 8 * mt + 2, tn // 8, kc // 8
    n_chunks = -(-cin // kc)
    y = np.zeros((b, h, w, ldw), np.float32)
    for co0 in range(0, ldw, tn):
        slab = np.zeros((9, ng, n_chunks * kc, 8), np.float32)  # the block's whole slab
        for tap in range(9):
            for g in range(ng):
                co = co0 + 8 * g
                if co < ldw:
                    slab[tap, g, :cin] = wmat[tap * cin:(tap + 1) * cin, co:co + 8]
        for img in range(b):
            for th0 in range(0, h, 8):
                for tw0 in range(0, w, 8 * mt):
                    acc = np.zeros((mt, 64, tn), np.float32)
                    for chunk in range(n_chunks):
                        c0 = chunk * kc
                        halo = np.zeros((planes, 10 * hc, 8), np.float32)
                        for p in range(10 * hc):
                            gh, gw = th0 + p // hc - 1, tw0 + p % hc - 1
                            if 0 <= gh < h and 0 <= gw < w:
                                for plane in range(planes):
                                    ci = c0 + 8 * plane
                                    if ci < cin:
                                        halo[plane, p] = x[img, gh, gw, ci:ci + 8]
                        for kk in range(kc // 16):
                            for tap in range(9):
                                ky, kx = divmod(tap, 3)
                                rows_b = slab[tap, :, c0 + 16 * kk:c0 + 16 * kk + 16]  # [ng, 16, 8]
                                b_mat = rows_b.transpose(1, 0, 2).reshape(16, tn)  # [depth, N]
                                for m in range(mt):
                                    start = ky * hc + 8 * m + kx
                                    rows = [start + (r // 8) * hc + r % 8 for r in range(64)]
                                    a_mat = np.concatenate([halo[2 * kk, rows], halo[2 * kk + 1, rows]],
                                                           axis=1)
                                    acc[m] += a_mat @ b_mat
                    for m in range(mt):
                        for r in range(64):
                            gh, gw = th0 + r // 8, tw0 + 8 * m + r % 8
                            if gh < h and gw < w:
                                live = min(tn, ldw - co0)
                                y[img, gh, gw, co0:co0 + live] = acc[m, r, :live]
    return y


def _as_the_kernel_gets_them(x, wmat):
    """The wrapper's padding: zero channels up to a multiple of 8 on ``x`` and
    on each tap's rows of the matrix, zero columns up to a multiple of 8."""
    cin = x.shape[-1]
    xt, wt = torch.from_numpy(x), torch.from_numpy(wmat)
    return pad_channels(xt).numpy(), pad_columns(pad_weight_channels(wt, cin)).numpy()


@pytest.mark.parametrize("shape,mt,tn,kc", [
    ((1, 8, 8, 16, 8), 1, 8, 16), ((2, 11, 19, 24, 40), 2, 64, 16), ((1, 16, 40, 8, 5), 4, 8, 16),
    ((1, 9, 33, 32, 32), 4, 32, 32), ((1, 9, 17, 256, 40), 2, 32, 32), ((1, 8, 12, 256, 10), 1, 16, 16),
    ((1, 10, 8, 48, 24), 1, 16, 64), ((1, 9, 10, 1, 12), 1, 16, 16), ((1, 8, 9, 10, 20), 2, 32, 16),
    ((1, 7, 8, 20, 1), 1, 8, 16)],
    ids=["one_patch", "ragged_24to40", "cout5", "32to32", "256to40_tn32", "256to10_tn16",
         "48to24_tn16_kc64", "padded_1to12", "padded_10to20", "padded_20to1"])
def test_kernel_layout_model_matches_plain(shape, mt, tn, kc):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wmat = (rng.normal(size=(9 * cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wmat)).numpy()
    xk, wk = _as_the_kernel_gets_them(x, wmat)
    assert xk.shape[-1] % 8 == 0 and wk.shape == (9 * xk.shape[-1], -(-cout // 8) * 8)
    got = _model_of_the_kernel(xk, wk, mt, tn, kc)
    assert not got[..., cout:].any()  # the padded columns are outputs that stay zero
    np.testing.assert_allclose(got[..., :cout], want, rtol=1e-4, atol=1e-5)


def _swizzle128(offset):
    """The 128-byte swizzle of TMA and wgmma on a 1024-aligned stage: the
    16-byte chunk index (bits 4-6) XOR the 128-byte row index (bits 7-9)."""
    return offset ^ (((offset >> 7) & 7) << 4)


def _model_of_the_stream_kernel(x, wmat, cout):
    """The streamed-weight kernel's data path in numpy, on the operands as the
    kernel receives them (``Cin`` a multiple of 8, the matrix's columns padded
    to a multiple of 8), with the constants and descriptor arithmetic of
    ``csrc/conv3x3_stream_wgmma.cu``: per tile (4 patches by 128 output
    channels) and chunk of 64 input channels, the halo written as TMA writes
    its per-plane boxes (zero outside the image and past ``Cin``), each tap's
    [64, 128] weight tile written in two 64-column halves with the 128-byte
    swizzle (zero past ``Cin`` and past ``ldw``), and per k16 step and patch
    one product whose A rows are read at the no-swizzle descriptor's strides
    and whose B rows at the swizzled descriptor's (LBO from one half to the
    other, SBO from 8 rows of depth to the next), each consumer warpgroup on
    its own two patches; the epilogue maps accumulator row r of patch p to
    pixel (r // 8, 8p + r % 8)."""
    k = _stream_constants()
    b, h, w, cin = x.shape
    ldw = wmat.shape[1]
    patches, tile_n, chunk = k["kPatches"], k["kTileN"], k["kChunk"]
    hc = 8 * patches + 2  # kHaloCols
    plane_bytes, half_bytes = -(-10 * hc * 16 // 128) * 128, chunk * 128
    w3 = wmat.reshape(9, cin, ldw)
    y = np.zeros((b, h, w, cout), np.float32)
    for co0 in range(0, cout, tile_n):
        for img in range(b):
            for th0 in range(0, h, 8):
                for tw0 in range(0, w, 8 * patches):
                    acc = np.zeros((patches, 64, tile_n), np.float32)
                    for c0 in range(0, cin, chunk):
                        halo = np.zeros(chunk // 8 * plane_bytes // 2, np.float32)  # 2-byte cells
                        for p in range(chunk // 8):
                            for r in range(10):
                                for c in range(hc):
                                    gh, gw, ci = th0 - 1 + r, tw0 - 1 + c, c0 + 8 * p
                                    if 0 <= gh < h and 0 <= gw < w and ci < cin:
                                        at = (p * plane_bytes + (r * hc + c) * 16) // 2
                                        halo[at:at + 8] = x[img, gh, gw, ci:ci + 8]
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            stage = np.zeros(tile_n // 64 * half_bytes // 2, np.float32)
                            for half in range(tile_n // 64):
                                for row in range(chunk):
                                    for j in range(64):
                                        ci, co = c0 + row, co0 + 64 * half + j
                                        if ci < cin and co < ldw:
                                            byte = _swizzle128(half * half_bytes + row * 128 + 2 * j)
                                            stage[byte // 2] = w3[tap, ci, co]
                            for kk in range(chunk // 16):
                                kd, nd = np.arange(16)[:, None], np.arange(tile_n)[None, :]
                                b_start = kk * 16 * 128  # + the stage's 1024-aligned base
                                b_bytes = (b_start + (nd // 64) * half_bytes + (kd // 8) * 1024
                                           + (kd % 8) * 128 + (nd % 64) * 2)
                                b_mat = stage[_swizzle128(b_bytes) // 2]
                                for consumer in range(2):
                                    for m in range(2):
                                        pm = 2 * consumer + m
                                        a_start = 2 * kk * plane_bytes + (ky * hc + 8 * pm + kx) * 16
                                        md, kd2 = np.arange(64)[:, None], np.arange(16)[None, :]
                                        a_bytes = (a_start + (kd2 // 8) * plane_bytes
                                                   + (md // 8) * hc * 16 + (md % 8) * 16
                                                   + (kd2 % 8) * 2)
                                        acc[pm] += halo[a_bytes // 2] @ b_mat
                    for pm in range(patches):
                        for r in range(64):
                            gh, gw = th0 + r // 8, tw0 + 8 * pm + r % 8
                            live = min(tile_n, cout - co0)
                            if gh < h and gw < w:
                                y[img, gh, gw, co0:co0 + live] = acc[pm, r, :live]
    return y


@pytest.mark.parametrize("shape", [(1, 8, 32, 64, 64), (1, 9, 35, 72, 136), (2, 11, 13, 24, 67)],
                         ids=["one_tile", "ragged_two_chunks_two_groups", "ragged_cin24_cout67"])
def test_stream_kernel_layout_model_matches_plain(shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(23)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wmat = (rng.normal(size=(9 * cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wmat)).numpy()
    xk, wk = _as_the_kernel_gets_them(x, wmat)
    got = _model_of_the_stream_kernel(xk, wk, cout)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cin", [1, 4, 10, 20])
@pytest.mark.parametrize("role", ["forward", "dgrad"])
def test_zero_padded_channels_give_the_unpadded_convolution(cin, role):
    """What the wrapper hands the tensor-core kernel for a ``Cin`` that is no
    multiple of 8 (``pad_channels`` on ``x``, ``pad_weight_channels`` on the
    matrix), through the plain version, equals the unpadded convolution: as a
    forward, and as the input gradient of a convolution whose ``Cout`` is that
    thin count (the flipped matrix's rows are then the thin side)."""
    rng = np.random.default_rng(cin)
    other = 24
    x = torch.from_numpy(rng.normal(size=(2, 9, 11, cin)).astype(np.float32))
    if role == "forward":
        wmat = torch.from_numpy(rng.normal(size=(9 * cin, other)).astype(np.float32))
    else:  # the forward was other -> cin; its input gradient reads cin channels of dy
        forward = torch.from_numpy(rng.normal(size=(9 * other, cin)).astype(np.float32))
        wmat = flip_transpose(forward, other, cin)
    cin8 = -(-cin // 8) * 8
    xp, wp = pad_channels(x), pad_weight_channels(wmat, cin)
    assert xp.shape == (2, 9, 11, cin8) and wp.shape == (9 * cin8, other)
    assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
    taps = wp.reshape(9, cin8, other)
    assert torch.equal(taps[:, :cin], wmat.reshape(9, cin, other)) and not taps[:, cin:].any()
    torch.testing.assert_close(conv3x3_plain(xp, wp), conv3x3_plain(x, wmat), rtol=1e-5, atol=1e-5)
    # a channel count that is already a multiple of 8 is handed over as it is
    w8 = torch.zeros(9 * 16, 3)
    assert pad_weight_channels(w8, 16) is w8 and pad_channels(xp) is xp


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_flash_forward_kernel_rule(head_dim):
    # bf16: the narrow tensor-core kernel up to head dim 128, the wide one above
    # (an unaligned view is copied first); f32: the FMA kernel
    assert flash_forward_kernel(torch.bfloat16, head_dim) == (
        "wgmma" if head_dim <= 128 else "wgmma_wide")
    assert flash_forward_kernel(torch.float32, head_dim) == "fma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_256_takes_the_fma_kernels(dtype):
    """One head over the 256 channels of config/ar_vae_dente_kl1e3.json's mid
    blocks ([B, 1, 4096, 256]): f32 takes the f32-FMA kernels both ways,
    bf16 the wide tensor-core kernels, at 256 as it is."""
    want = "wgmma_wide" if dtype == torch.bfloat16 else "fma"
    assert flash_forward_kernel(dtype, 256) == want == flash_backward_kernel(dtype, 256)
    assert padded_head_dim(256, dtype) == 256


@pytest.mark.parametrize("head_dim", [256, 48, 8, 512])
def test_flash_check_accepts_256_and_rejects_other_head_dims(head_dim):
    """The launch takes the widths its route is built for: f32 16 ... 512
    (powers of two) and multiples of 64 above 512; bf16 16 ... 128 and
    multiples of 64 above 128. Others must be padded first."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 1, 4, head_dim, dtype=dtype)
        if head_dim in SUPPORTED_HEAD_DIMS:
            flash_check(q, q, q)
        else:
            with pytest.raises(ValueError, match="head dim"):
                flash_check(q, q, q)


def _unaligned(shape, dtype):
    """A contiguous view of ``shape`` whose base address is 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 8, dtype=dtype)
    view = flat[1:1 + int(np.prod(shape))].view(shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [192, 256, 320, 512, 640, 1024])
def test_flash_wide_head_dim_dispatch(head_dim, dtype):
    """Head dims above 128: bf16 on the wide tensor-core kernels at any
    multiple of 64, both ways; f32 on the FMA kernels, at 256 and 512 (their
    instantiations) and at multiples of 64 above 512 (their split kernels). A
    head dim the route does not take pads to the next one it does. The
    launch takes an unaligned view in f32 and refuses it in bf16, where
    ``flash_attention`` copies it first (the tensor-core kernels read 16
    bytes at a time)."""
    fma_dim = head_dim if head_dim in (256, 512) or head_dim > 512 else (256 if head_dim < 256 else 512)
    assert flash_forward_kernel(torch.bfloat16, head_dim) == "wgmma_wide"
    assert flash_backward_kernel(torch.bfloat16, head_dim) == "wgmma_wide"
    assert flash_forward_kernel(torch.float32, head_dim) == "fma"
    assert flash_backward_kernel(torch.float32, head_dim) == "fma"
    want = head_dim if dtype == torch.bfloat16 else fma_dim
    assert padded_head_dim(head_dim, dtype) == want
    q = torch.zeros(1, 1, 4, want, dtype=dtype)
    flash_check(q, q, q)
    u = _unaligned((1, 1, 4, want), dtype)
    if dtype == torch.float32:
        flash_check(u, u, u)
    else:
        with pytest.raises(ValueError, match="aligned"):
            flash_check(u, u, u)
        flash_check(*(t.clone() for t in (u, u, u)))  # the wrapper's copies


@pytest.mark.parametrize("head_dim", [100, 200, 600, 1000])
def test_flash_unaligned_widths_pad_to_a_route_that_takes_them(head_dim):
    """Widths no route takes as they are: the padded width is taken by the
    route of the padded copy, in both types, and the copy is aligned."""
    for dtype in (torch.float32, torch.bfloat16):
        d_pad = padded_head_dim(head_dim, dtype)
        assert d_pad > head_dim and d_pad - head_dim < max(64, head_dim)
        u = _unaligned((1, 1, 4, head_dim), dtype)
        q = pad_head_dim(u, d_pad)
        assert q.data_ptr() % 16 == 0
        flash_check(q, q, q)


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_flash_fma_backward_tile_fits_shared_memory(head_dim):
    """The FMA backward's staged tiles at every head dim: 64 rows up to 128,
    32 at 256, where 64 rows would need 296,960 (dk/dv) and 280,320 (dq)
    bytes, over the 232,448 a block may have on sm_90, and 16 at 512, where
    32 rows would need 271,360."""
    tile = bwd_fma_tile(head_dim)
    dkdv, dq = bwd_fma_smem_bytes(head_dim)
    assert tile == (64 if head_dim <= 128 else 32 if head_dim <= 256 else 16) and tile % 16 == 0
    assert max(dkdv, dq) <= 232_448
    # the formula of csrc/flash_attention_bwd.cu: four [tile][D+1] f32 tiles,
    # [tile][tile+1] p and ds (dq: ds only), lse and delta of the tile's rows
    assert dkdv == 4 * (4 * tile * (head_dim + 1) + 2 * tile * (tile + 1) + 2 * tile)
    assert dq == dkdv - 4 * tile * (tile + 1)
    if head_dim == 256:
        assert (dkdv, dq) == (140_288, 136_064)
        rows64 = 4 * (4 * 64 * 257 + 2 * 64 * 65 + 2 * 64)
        assert rows64 == 296_960 > 232_448
    if head_dim == 512:
        assert (dkdv, dq) == (133_632, 132_544)
        rows32 = 4 * (4 * 32 * 513 + 2 * 32 * 33 + 2 * 32)
        assert rows32 == 271_360 > 232_448


def test_flash_forward_smem_at_head_dim_256():
    """``smem_floats<256>`` of csrc/flash_attention.cu: q [64][D], k [64][D+1],
    v [64][D], p [64][65] and three row vectors, 214,272 bytes."""
    d = 256
    assert 4 * (64 * d + 64 * (d + 1) + 64 * d + 64 * 65 + 3 * 64) == 214_272 <= 232_448
    assert (fwd_fma_tile(d), fwd_fma_smem_bytes(d)) == (64, 214_272)


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_flash_forward_tile_fits_shared_memory(head_dim):
    """The FMA forward's tiles: 64 rows up to head dim 256, 32 at 512, where
    64 rows would need 410,880 bytes; 32 rows need 201,344."""
    rows, nbytes = fwd_fma_tile(head_dim), fwd_fma_smem_bytes(head_dim)
    assert rows == (64 if head_dim <= 256 else 32) and nbytes <= 232_448
    if head_dim == 512:
        assert nbytes == 201_344
        assert 4 * (64 * 512 + 64 * 513 + 64 * 512 + 64 * 65 + 3 * 64) == 410_880 > 232_448


@pytest.mark.parametrize("head_dim", [576, 640, 1024, 4096])
def test_flash_fma_split_fits_shared_memory_at_any_head_dim(head_dim):
    """Above head dim 512 the FMA kernels split D (``split_smem_floats``,
    ``dkdv_split_smem_floats``, ``dq_split_smem_floats``): 64-row tiles, q / k
    chunks of 64 columns ([64][64] and [64][65] f32) beside a 128-column v
    slice and p in the forward, four [64][65] chunks, the slice's [64][129]
    tiles (two for dk/dv, one for dq), p and ds in the backward; the same
    bytes at every head dim, where whole-D tiles grow with it (the 32-row
    forward tile of D = 512 would need 397,952 bytes at D = 1024)."""
    assert fwd_fma_tile(head_dim) == bwd_fma_tile(head_dim) == 64
    assert fwd_fma_smem_bytes(head_dim) == 4 * (64 * 64 + 64 * 65 + 64 * 128 + 64 * 65 + 3 * 64) == 83_200
    dkdv, dq = bwd_fma_smem_bytes(head_dim)
    assert dkdv == 4 * (4 * 64 * 65 + 2 * 64 * 129 + 2 * 64 * 65 + 2 * 64) == 166_400
    assert dq == 4 * (4 * 64 * 65 + 64 * 129 + 64 * 65 + 2 * 64) == 116_736
    assert 4 * (32 * 1024 + 32 * 1025 + 32 * 1024 + 32 * 33 + 3 * 32) == 397_952 > 232_448


def test_new_sources_are_built_with_the_rest():
    assert "conv3x3_wgmma.cu" in CONV_SOURCES and "conv3x3.cu" in CONV_SOURCES
    assert "conv3x3_stream_wgmma.cu" in CONV_SOURCES
    assert "flash_attention_wgmma.cu" in FLASH_SOURCES and "flash_attention.cu" in FLASH_SOURCES
    assert "conv3x3_wgrad_wgmma.cu" in CONV_SOURCES and "conv3x3_wgrad.cu" in CONV_SOURCES
    assert "flash_attention_bwd_wgmma.cu" in FLASH_SOURCES and "flash_attention_bwd.cu" in FLASH_SOURCES
    assert {"flash_attention_wide_wgmma.cu", "flash_attention_bwd_wide_wgmma.cu"} <= set(FLASH_SOURCES)
    for source in (*CONV_SOURCES, *FLASH_SOURCES):
        assert (_build.CSRC_DIR / source).is_file()


@pytest.mark.parametrize("source", ["conv3x3_wgmma.cu", "conv3x3_stream_wgmma.cu",
                                    "flash_attention_wgmma.cu",
                                    "conv3x3_wgrad_wgmma.cu", "flash_attention_bwd_wgmma.cu",
                                    "flash_attention_wide_wgmma.cu",
                                    "flash_attention_bwd_wide_wgmma.cu"])
def test_build_hash_covers_included_headers(source, tmp_path, monkeypatch):
    shutil.copytree(_build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    assert [p.name for p in _build.source_files(source)] == [source, "hopper_mma.cuh"]
    before = _build.library_path(source)
    untouched = _build.library_path("conv3x3.cu")
    header = tmp_path / "csrc" / "hopper_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(source) != before
    assert _build.library_path("conv3x3.cu") == untouched  # includes no header of csrc/
    main = tmp_path / "csrc" / source
    main.write_text(main.read_text() + "\n// edited\n")
    assert _build.library_path(source).name.startswith(source.removesuffix(".cu") + "_")


def test_build_hash_follows_nested_includes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#include "c.cuh"\n#include "b.cuh"\n#include "absent.cuh"\n')
    (csrc / "c.cuh").write_text("// leaf\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [p.name for p in _build.source_files("a.cu")] == ["a.cu", "b.cuh", "c.cuh"]
    before = _build.library_path("a.cu")
    (csrc / "c.cuh").write_text("// leaf, edited\n")
    assert _build.library_path("a.cu") != before


@pytest.mark.parametrize("variant", ["no_weights", "no_halo", "no_loads", "one_tap", "no_store",
                                     "none_of_them"])
def test_stream_ablation_variants_still_apply(variant):
    """``tools/ablate_conv3x3_stream.py`` edits the streamed-weight kernel's
    source by string replacement: each edit must still find its one place."""
    from tools import ablate_conv3x3_stream as ablate

    source = (_build.CSRC_DIR / "conv3x3_stream_wgmma.cu").read_text()
    assert ablate.VARIANTS[variant](source) != source
