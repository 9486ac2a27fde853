"""Spatial sharding of the port (``pti_ldm_vae_tpu_torch/parallel/spatial.py``)
against the JAX package on the CPU.

One ``torchrun --standalone --nproc_per_node 2`` launch (gloo) runs the
cases of ``tests/torch_model_parallel.py`` with image height split over a
model group of 2 (``data = 1``: the run is the one-process run at batch 4),
while the JAX package computes the same functions unsharded on the same
inputs and weights (``tests/test_spatial_sharding.py`` holds the JAX
package's own sharded run to its unsharded one):

* the reconstruct at rtol 1e-4 / atol 1e-5, through cuDNN, through the
  convolution kernels' plain versions (haloed tiles, edge rows cropped) and
  in the s2d form (the last two against the port's one-process reconstruct
  of the same form, which the single-device tests hold to JAX);
* one adversarial step with LPIPS and the AR-VAE term (the generator and
  the discriminator): the loss terms and the parameters after Adam against
  JAX at rtol 2e-4 / atol 1e-5 (entries whose gradient is below 1e-4 of
  their tensor's largest, and a key projection's bias, whose gradient is 0 in
  exact arithmetic, where Adam's sign step can go either way, within 2 lr),
  the gradients each optimizer steps on against the port's
  one-process step at rtol 2e-4 with atol 1e-5 x the tensor's largest
  entry (the same sums in another order);
* ``first_local_rows`` stitching the tiles, and the two ranks' results
  equal.

Single-process cases with no launch split a tensor into height pieces and
hold each module's sharded form on a piece, its collectives emulated from
the whole tensor, to the whole: the split GroupNorm+SiLU plain entries, the
haloed 3x3 convolutions (cuDNN and the kernel path), the stride-2
downsample, the s2d convolutions and the gathered attention block. The
flagship's widths at 64² and ``dryrun_multichip(4)`` (a 2 x 2 mesh) are
``slow``.
"""

import contextlib
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_model_parallel as tmp  # noqa: E402

from pti_ldm_vae_tpu_torch.models import autoencoder_kl as ae  # noqa: E402
from pti_ldm_vae_tpu_torch.ops import norm as norm_ops  # noqa: E402
from pti_ldm_vae_tpu_torch.ops.space_to_depth import space_to_depth  # noqa: E402
from pti_ldm_vae_tpu_torch.parallel import spatial as sp  # noqa: E402

gn = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")
TINY = tmp.tiny_def((False, False))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tmp.world("spatial", TINY, tmp_path_factory.mktemp("torch_spatial"))


@pytest.mark.parametrize("form", ["recon", "recon_kernel", "recon_s2d"])
def test_reconstruct_matches_jax(world, form):
    tmp.check_reconstruct(world, form)


def test_step_loss_terms_match_jax(world):
    tmp.check_loss_terms(world)


@pytest.mark.parametrize("which", ["g", "d"])
def test_step_gradients_match_one_process(world, which):
    tmp.check_gradients(world, which)


@pytest.mark.parametrize("which", ["g", "d"])
def test_parameters_after_adam_match_jax(world, which):
    tmp.check_parameters(world, which)


def test_first_local_rows_stitches_the_tiles(world):
    for got in world["ranks"]:
        np.testing.assert_array_equal(got["first_local_rows"], world["data"]["images"].numpy())


def test_both_ranks_hold_the_same_results(world):
    tmp.check_same_ranks(world)


def test_checkpoints_are_the_unsharded_runs(world):
    tmp.check_checkpoints(world)


# ---- single process: height pieces against the whole --------------------------------------

@contextlib.contextmanager
def _tile(monkeypatch, full: torch.Tensor, m: int, pieces: int):
    """Run a module of ``autoencoder_kl`` on piece ``m`` of ``full`` (cut by
    height into ``pieces``) as a rank of a spatial model group would, its
    halo rows and gathers taken from ``full`` (with the tensor the module
    hands them, which must be this piece's)."""
    h = full.shape[1] // pieces

    def halo(x, top, bottom):
        padded = torch.nn.functional.pad(full, (0, 0, 0, 0, top, bottom))
        return padded[:, m * h:m * h + h + top + bottom]

    monkeypatch.setattr(ae, "spatial", lambda: True)
    monkeypatch.setattr(ae, "halo_rows", halo)
    monkeypatch.setattr(ae, "gather_height", lambda x, partitioned=False: full)
    monkeypatch.setattr(ae, "model_rank", lambda: m)
    yield full[:, m * h:(m + 1) * h]


def _pieces_match(monkeypatch, module, full, pieces, scale=1, **kw):
    want = module(full, **kw)
    for m in range(pieces):
        with monkeypatch.context() as mp, _tile(mp, full, m, pieces) as piece:
            got = module(piece, **kw)
        h = got.shape[1]
        np.testing.assert_allclose(got.detach().numpy(), want[:, m * h:(m + 1) * h].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert h * pieces * scale == full.shape[1]


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("shape,groups", [((2, 16, 8, 16), 4), ((3, 8, 5, 12), 3)])
def test_split_groupnorm_silu_pieces_match_the_whole(pieces, shape, groups):
    """Partial statistics summed, then applied per piece; partial backward
    sums summed, then dx per piece: the whole's plain forward and backward."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen)
    scale, bias = 1 + 0.1 * torch.randn(shape[-1], generator=gen), 0.1 * torch.randn(
        shape[-1], generator=gen)
    g = torch.randn(shape, generator=gen)
    y, mean_g, inv_g = gn._plain_forward(x, scale, bias, groups, 1e-6)
    dx, dscale, dbias = gn.groupnorm_silu_bwd_plain(x, scale, bias, mean_g, inv_g, g, groups)
    parts, gparts = x.chunk(pieces, dim=1), g.chunk(pieces, dim=1)
    count = shape[1] * shape[2] * shape[-1] // groups
    mean, inv = gn.split_moments(sum(gn.groupnorm_silu_split_stats_plain(p, groups) for p in parts),
                                 count, 1e-6)
    got_y = torch.cat([gn.groupnorm_silu_split_apply_plain(p, scale, bias, mean, inv, groups)
                       for p in parts], dim=1)
    r = sum(gn.groupnorm_silu_split_bwd_reduce_plain(p, q, scale, bias, mean, inv, groups)
            for p, q in zip(parts, gparts))
    got_dx = torch.cat([gn.groupnorm_silu_split_bwd_dx_plain(p, q, scale, bias, mean, inv, r, groups,
                                                             count) for p, q in zip(parts, gparts)],
                       dim=1)
    for a, b in ((got_y, y), (got_dx, dx), (r.sum(0)[1], dscale), (r.sum(0)[0], dbias)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_split_function_of_one_piece_is_the_fused_plain_path():
    """The split Function with the identity as all-reduce: the fused plain
    path's outputs and gradients."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 6, 16, generator=gen, requires_grad=True)
    s = (1 + 0.1 * torch.randn(16, generator=gen)).requires_grad_()
    b = (0.1 * torch.randn(16, generator=gen)).requires_grad_()
    g = torch.randn(2, 8, 6, 16, generator=gen)
    got = gn.groupnorm_silu_split(x, s, b, 4, 1e-6, lambda t: t, 48)
    want = gn.groupnorm_silu(x, s, b, 4, 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    for a, e in zip(torch.autograd.grad(got, (x, s, b), g), torch.autograd.grad(want, (x, s, b), g)):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conv_kernel", [False, True])
@pytest.mark.parametrize("pieces", [2, 4])
def test_haloed_conv3x3_pieces_match_the_whole(monkeypatch, conv_kernel, pieces):
    torch.manual_seed(2)
    conv = ae.Convolution(6, 5, 3, padding=1, conv_kernel=conv_kernel)
    _pieces_match(monkeypatch, conv, torch.randn(2, 16, 7, 6), pieces)


@pytest.mark.parametrize("pieces", [2, 4])
def test_stride2_downsample_pieces_match_the_whole(monkeypatch, pieces):
    torch.manual_seed(3)
    down = ae.Downsample(6, torch.float32)
    _pieces_match(monkeypatch, down, torch.randn(2, 16, 9, 6), pieces, scale=2)


@pytest.mark.parametrize("kind", ["conv3x3", "downsample"])
def test_s2d_convolution_pieces_match_the_whole(monkeypatch, kind):
    torch.manual_seed(4)
    module = (ae.Convolution(3, 4, 3, padding=1) if kind == "conv3x3"
              else ae.Downsample(3, torch.float32))
    full = space_to_depth(torch.randn(2, 16, 8, 3))
    _pieces_match(monkeypatch, module, full, 2, s2d=True)  # the s2d downsample keeps the s2d height


def test_gathered_attention_block_keeps_its_rows(monkeypatch):
    torch.manual_seed(5)
    block = ae.SpatialAttentionBlock(8, 4, 1e-6, "one_pass", torch.float32)
    _pieces_match(monkeypatch, block, torch.randn(2, 8, 4, 8), 2)


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_group_norm_silu_of_a_tile_uses_the_images_statistics(monkeypatch, stats):
    """``group_norm_silu_tiles`` on a tile whose model group's
    other tile is the same rows (the all-reduce emulated as doubling): the
    whole image's result on its first half; one-pass through the split
    entries, two-pass as plain code."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 4, 6, 8, generator=gen, requires_grad=True)
    s, b = 1 + 0.1 * torch.randn(8, generator=gen), 0.1 * torch.randn(8, generator=gen)
    g = torch.randn(2, 4, 6, 8, generator=gen)
    monkeypatch.setattr(sp, "model_size", lambda: 2)
    monkeypatch.setattr(sp, "reduce_model_", lambda t: t.mul_(2))
    monkeypatch.setattr(sp, "sum_over_model", lambda t, partitioned=False: t * 2)
    before = dict(gn.groupnorm_silu.split_launches)
    got = sp.group_norm_silu_tiles(x, s, b, num_groups=4, eps=1e-6, stats=stats)
    whole = torch.cat([x, x], dim=1)
    want = norm_ops.group_norm_silu(whole, s, b, num_groups=4, stats=stats)[:, :4]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert gn.groupnorm_silu.split_launches == before  # plain versions on the CPU count nothing
    dx = torch.autograd.grad(got, x, g)[0]
    assert torch.isfinite(dx).all() and dx.shape == x.shape


def test_shard_batch_spatial_cuts_images_only(monkeypatch):
    monkeypatch.setattr(sp, "model_rank", lambda: 1)
    monkeypatch.setattr(sp, "model_size", lambda: 2)
    batch = {"image": np.arange(2 * 8 * 3).reshape(2, 8, 3, 1).astype(np.float32),
             "mask": np.ones(2, np.float32), "attributes": {"h": np.zeros(2, np.float32)}}
    out = sp.shard_batch_spatial(batch)
    np.testing.assert_array_equal(out["image"], batch["image"][:, 4:])
    assert out["mask"] is batch["mask"] and out["attributes"]["h"] is batch["attributes"]["h"]
    with pytest.raises(ValueError, match="NHWC"):
        sp.spatial_split(np.zeros((2, 8, 3)))


# ---- slow: the flagship's widths, a 2 x 2 mesh ------------------------------------------------

@pytest.mark.slow
def test_flagship_widths_at_64_under_spatial_2(tmp_path):
    """The production architecture (``config/vae_dente_no_adv.json``'s
    widths) at 64², batch 4, spatial 2: the same step as the toy cases
    against the port's one process. The loss terms at rtol 1e-4 / atol
    1e-5, the reconstructs at the flagship's bar of ``test_torch_model.py``
    (1e-3 absolute: at this depth the one-pass variance's rounding shows)."""
    flagship = {**tmp.tiny_def((False, False)), "channels": [32, 64, 128, 128],
                "num_res_blocks": 2, "norm_num_groups": 16, "attention_levels": [False] * 4}
    data = tmp.make_inputs(flagship)
    data["images"] = torch.rand(4, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    data["eps"] = torch.randn(4, 8, 8, 2, generator=torch.Generator().manual_seed(1))
    proc, log = tmp.start_launch("spatial", data, tmp_path)
    try:
        one = tmp.port_case(data, None, tmp_path / "one")
    finally:
        ranks = tmp.finish_launch(proc, log, tmp_path)
    for key, want in one.items():
        if key.startswith("metric/"):
            np.testing.assert_allclose(ranks[0][key], want, rtol=1e-4, atol=1e-5, err_msg=key)
        elif key.startswith("recon"):  # the flagship's reconstruct bar (test_torch_model.py)
            assert np.abs(ranks[0][key] - want).max() <= 1e-3, key


@pytest.mark.slow
def test_dryrun_multichip_4_on_the_cpu():
    """dp x sp (2 x 2), dp x tp (2 x 2) with their losses held to each other,
    then the LDM stage, on four gloo ranks."""
    import subprocess

    proc = subprocess.run([sys.executable, "-m", "pti_ldm_vae_tpu_torch.parallel.dryrun", "4",
                           "--device", "cpu"], capture_output=True, text=True, timeout=600,
                          env={**__import__("os").environ, "PYTHONPATH": str(tmp.ROOT),
                               "OMP_NUM_THREADS": "1", "PTI_LPIPS_WEIGHTS": "none"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "tensor-parallel stage ok" in proc.stdout and "LDM stage ok" in proc.stdout
