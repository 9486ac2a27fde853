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
    assert "flash_attention_wgmma.cu" in FLASH_SOURCES and "flash_attention.cu" in FLASH_SOURCES
    assert "conv3x3_wgrad_wgmma.cu" in CONV_SOURCES and "conv3x3_wgrad.cu" in CONV_SOURCES
    assert "flash_attention_bwd_wgmma.cu" in FLASH_SOURCES and "flash_attention_bwd.cu" in FLASH_SOURCES
    assert {"flash_attention_wide_wgmma.cu", "flash_attention_bwd_wide_wgmma.cu"} <= set(FLASH_SOURCES)
    for source in (*CONV_SOURCES, *FLASH_SOURCES):
        assert (_build.CSRC_DIR / source).is_file()


@pytest.mark.parametrize("source", ["conv3x3_wgmma.cu", "flash_attention_wgmma.cu",
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
