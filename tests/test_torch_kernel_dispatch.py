"""Host-side pieces of the port's tensor-core kernels, on the CPU: the rules
that pick a kernel by dtype and shape, the tile choice, the zero-padding of
the weight matrix, a numpy model of the kernel's shared-memory layout and
descriptor addressing against the plain version, and the build hash.

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
    conv3x3_plain,
    flip_transpose,
    forward_kernel,
    pad_columns,
    wgmma_smem_bytes,
    wgmma_tile,
)
from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    SOURCES as FLASH_SOURCES,
    SUPPORTED_HEAD_DIMS,
    forward_kernel as flash_forward_kernel,
)

# (B, H, W, Cin, Cout) of the 47 3x3 convolutions of a flagship pass at 256², batch 8
PATH_SHAPES = [
    (8, 128, 128, 128, 128), (8, 256, 256, 64, 64), (8, 128, 128, 128, 64), (8, 256, 256, 64, 32),
    (8, 256, 256, 32, 32), (8, 128, 128, 64, 64), (8, 64, 64, 128, 128), (8, 128, 128, 32, 64),
    (8, 64, 64, 64, 128), (8, 32, 32, 128, 128), (8, 256, 256, 1, 32), (8, 256, 256, 32, 1),
    (8, 32, 32, 128, 4), (8, 32, 32, 4, 128),
]
RAGGED_FMA = (1, 20, 12, 3, 5)
RAGGED_WGMMA = (2, 37, 70, 24, 40)
N_SM = 132  # an H100


def _id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", PATH_SHAPES + [RAGGED_FMA, RAGGED_WGMMA], ids=_id)
def test_conv_forward_kernel_rule(shape):
    cin, cout = shape[3], shape[4]
    # f32 never leaves the FMA kernel, as forward or as input gradient
    assert forward_kernel(torch.float32, cin) == "fma"
    assert forward_kernel(torch.float32, cout) == "fma"
    # bf16: the tensor-core kernel wherever the channel count that plays Cin fills 16-byte pieces
    assert forward_kernel(torch.bfloat16, cin) == ("wgmma" if cin % 8 == 0 else "fma")
    assert forward_kernel(torch.bfloat16, cout) == ("wgmma" if cout % 8 == 0 else "fma")
    # an unaligned base address keeps any shape on the FMA kernel
    assert forward_kernel(torch.bfloat16, cin, aligned=False) == "fma"


def test_conv_forward_kernel_rule_on_the_path():
    forward = [forward_kernel(torch.bfloat16, s[3]) for s in PATH_SHAPES]
    dgrad = [forward_kernel(torch.bfloat16, s[4]) for s in PATH_SHAPES]
    # the 1-channel stem and the 4-channel latent are the only thin inputs
    assert forward.count("fma") == 2 and dgrad.count("fma") == 2
    assert forward_kernel(torch.bfloat16, RAGGED_FMA[3]) == "fma"
    assert forward_kernel(torch.bfloat16, RAGGED_WGMMA[3]) == "wgmma"
    assert forward_kernel(torch.float16, 32) == "fma"  # (the wrapper refuses the dtype)
    assert forward_kernel(torch.bfloat16, 128) == "wgmma" and forward_kernel(torch.bfloat16, 136) == "fma"


@pytest.mark.parametrize("shape", PATH_SHAPES + [RAGGED_WGMMA], ids=_id)
def test_wgmma_tile_covers_the_shape_and_spreads_over_the_card(shape):
    b, h, w, cin, cout = shape
    cin = max(cin, 8)  # (the thin inputs never reach the tensor-core kernel)
    mt, tn, kc = wgmma_tile(b, h, w, cin, cout, N_SM)
    assert mt in (4, 2, 1) and tn in (8, 32, 64) and kc in (16, 32, 64)
    assert tn >= min(cout, 64) and (tn == 8 or cout > {32: 8, 64: 32}[tn])
    tiles = b * -(-h // 8) * -(-w // (8 * mt)) * -(-cout // tn)
    wider = b * -(-h // 8) * -(-w // (16 * mt)) * -(-cout // tn)
    assert 2 * tiles >= N_SM or mt == 1  # at least a tile per two SMs
    assert mt == 4 or 2 * wider < N_SM  # and no wider tile would have given that
    assert kc == 16 or kc <= cin  # a step no deeper than the input
    assert wgmma_smem_bytes(cin, mt, tn, kc) <= 232448  # what a block may ask for on sm_90


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


def test_wgmma_smem_bytes_matches_the_kernel_formula():
    # slab 9 * (tn/8) * (16*Cin + 16), three stages of kc/8 padded planes, 64 * (2*tn + 16)
    assert wgmma_smem_bytes(128, 4, 64, 32) == 9 * 8 * 2064 + 3 * 4 * 5520 + 64 * 144
    assert wgmma_smem_bytes(32, 4, 32, 32) == 9 * 4 * 528 + 3 * 4 * 5520 + 64 * 80
    assert wgmma_smem_bytes(24, 1, 64, 16) == 9 * 8 * (32 * 16 + 16) + 3 * 2 * 1680 + 64 * 144
    assert wgmma_smem_bytes(128, 4, 64, 64) > 232448  # the rule must not pick it


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


def _model_of_the_kernel(x, wmat, mt, tn):
    """The tensor-core convolution kernel's data path in numpy: per tile and
    chunk of 16 input channels the halo as two planes ``[plane][halo row][halo
    column][8]``, the weight slab as ``[tap][N-group][16 rows][8]``, and per
    tap one product whose A rows are read at the descriptor's strides (8
    pixels of a halo row; the next output row one halo row further; the next 8
    channels one plane further) from the start moved by (ky, kx)."""
    b, h, w, cin = x.shape
    cout = wmat.shape[1]
    ldw = -(-cout // 8) * 8
    wpad = np.zeros((9 * cin, ldw), np.float32)
    wpad[:, :cout] = wmat
    hc, ng = 8 * mt + 2, tn // 8
    y = np.zeros((b, h, w, cout), np.float32)
    for img in range(b):
        for th0 in range(0, h, 8):
            for tw0 in range(0, w, 8 * mt):
                for co0 in range(0, cout, tn):
                    acc = np.zeros((mt, 64, tn), np.float32)
                    for c0 in range(0, cin, 16):
                        planes = np.zeros((2, 10 * hc, 8), np.float32)
                        for p in range(10 * hc):
                            gh, gw = th0 + p // hc - 1, tw0 + p % hc - 1
                            for plane in range(2):
                                ci = c0 + 8 * plane
                                if 0 <= gh < h and 0 <= gw < w and ci < cin:
                                    planes[plane, p] = x[img, gh, gw, ci:ci + 8]
                        slab = np.zeros((9, ng, 16, 8), np.float32)
                        for tap in range(9):
                            for k in range(16):
                                for g in range(ng):
                                    ci, co = c0 + k, co0 + 8 * g
                                    if ci < cin and co < ldw:
                                        slab[tap, g, k] = wpad[tap * cin + ci, co:co + 8]
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            b_mat = slab[tap].transpose(1, 0, 2).reshape(16, tn)  # [depth, N]
                            for m in range(mt):
                                start = ky * hc + 8 * m + kx
                                rows = [start + (r // 8) * hc + r % 8 for r in range(64)]
                                a_mat = np.concatenate([planes[0, rows], planes[1, rows]], axis=1)
                                acc[m] += a_mat @ b_mat
                    for m in range(mt):
                        for r in range(64):
                            gh, gw = th0 + r // 8, tw0 + 8 * m + r % 8
                            if gh < h and gw < w:
                                live = min(tn, cout - co0)
                                y[img, gh, gw, co0:co0 + live] = acc[m, r, :live]
    return y


@pytest.mark.parametrize("shape,mt,tn", [((1, 8, 8, 16, 8), 1, 8), ((2, 11, 19, 24, 40), 2, 64),
                                         ((1, 16, 40, 8, 5), 4, 8), ((1, 9, 33, 32, 32), 4, 32)],
                         ids=["one_patch", "ragged_24to40", "cout5", "32to32"])
def test_kernel_layout_model_matches_plain(shape, mt, tn):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wmat = (rng.normal(size=(9 * cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wmat)).numpy()
    np.testing.assert_allclose(_model_of_the_kernel(x, wmat, mt, tn), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_flash_forward_kernel_rule(head_dim):
    assert flash_forward_kernel(torch.bfloat16, head_dim) == "wgmma"
    assert flash_forward_kernel(torch.float32, head_dim) == "fma"
    assert flash_forward_kernel(torch.bfloat16, head_dim, aligned=False) == "fma"


def test_new_sources_are_built_with_the_rest():
    assert "conv3x3_wgmma.cu" in CONV_SOURCES and "conv3x3.cu" in CONV_SOURCES
    assert "flash_attention_wgmma.cu" in FLASH_SOURCES and "flash_attention.cu" in FLASH_SOURCES
    for source in (*CONV_SOURCES, *FLASH_SOURCES):
        assert (_build.CSRC_DIR / source).is_file()


@pytest.mark.parametrize("source", ["conv3x3_wgmma.cu", "flash_attention_wgmma.cu"])
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
