"""Tensor (channel) sharding of the port (``pti_ldm_vae_tpu_torch/parallel/tensor.py``)
against the JAX package on the CPU.

One ``torchrun --standalone --nproc_per_node 2`` launch (gloo) runs the
cases of ``tests/torch_model_parallel.py`` with the parameters channel
sharded over a model group of 2 (``data = 1``: the run is the one-process run
at batch 4) on the toy model of ``tests/test_tensor_parallel.py`` (level-1
attention on), while the JAX package computes the same functions
replicated on the same inputs and weights, with the bars of
``tests/test_torch_spatial_parallel.py``: the reconstructs (rtol 1e-4 / atol
1e-5), one adversarial step with LPIPS and the AR-VAE term (loss terms and
parameters after Adam against JAX at rtol 2e-4 / atol 1e-5, gradients against
the port's one process), Adam's moments split (a sharded parameter's hold
its block on each rank, as ``tests/test_tensor_parallel.py:90-100`` asserts
of JAX), the checkpoints rank 0 writes equal to the one-process run's key
for key (value for value before the step) and both resume paths taking
them back.

Single-process cases: which parameters shard and their blocks' shapes
against the JAX ``tensor_parallel_params`` on the suite's 8-CPU mesh
(data 4 x model 2), a channel block's GroupNorm against the whole's, a state
dict cut and put back together, and ``check_parallelism``'s errors. The
flagship's widths at 64² are ``slow``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_model_parallel as tmp  # noqa: E402

from pti_ldm_vae_tpu_torch.models import autoencoder_kl as ae  # noqa: E402
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config  # noqa: E402
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator  # noqa: E402
from pti_ldm_vae_tpu_torch.parallel.mesh import Mesh, set_mesh  # noqa: E402
from pti_ldm_vae_tpu_torch.parallel.tensor import (  # noqa: E402
    shard_optimizer_state,
    shard_state_dict,
    shardable,
    tensor_parallel_params,
)
from pti_ldm_vae_tpu_torch.train.loop import check_parallelism  # noqa: E402

TINY = tmp.tiny_def((False, True))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tmp.world("tensor", TINY, tmp_path_factory.mktemp("torch_tensor"))


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


def test_adam_state_is_split(world):
    """Each rank's Adam moments of a sharded parameter hold its block: half
    the rows; a replicated parameter's all of them."""
    one = world["one"]
    halves = 0
    for key, rows in one.items():
        if not key.startswith("adam_rows/"):
            continue
        full = int(rows)
        want = full // 2 if shardable((full,), 2) else full
        for got in world["ranks"]:
            assert int(got[key]) == want, key
        halves += want != full
    assert halves > 10


def test_both_ranks_hold_the_same_results(world):
    tmp.check_same_ranks(world)


def test_checkpoints_are_the_unsharded_runs(world):
    tmp.check_checkpoints(world)


# ---- single process -----------------------------------------------------------------------

@pytest.fixture
def fake_rank():
    """A tensor mesh of 2 with this process as rank ``m`` and no groups (the
    cases below make no collective)."""
    def make(m: int) -> None:
        set_mesh(Mesh("tensor", 1, 2, 0, m, None, None))

    yield make
    set_mesh(None)


def test_sharded_leaves_match_jax_tensor_parallel_params(fake_rank):
    """The same parameters shard, by MONAI key, and a rank's block is the
    JAX shard's shape (the trailing axis there, dim 0 here): the generator's
    and the discriminator's."""
    import jax
    from jax.sharding import PartitionSpec as P

    from pti_ldm_vae_tpu.checkpoint.torch_convert import (
        disc_from_torch_state_dict,
        disc_to_torch_state_dict,
        from_torch_state_dict,
        to_torch_state_dict,
    )
    from pti_ldm_vae_tpu.parallel.mesh import make_mesh
    from pti_ldm_vae_tpu.parallel.tensor import tensor_parallel_params as jax_tp

    mesh = make_mesh(jax.devices(), data=4, model=2)
    cases = ((lambda: autoencoder_from_config(TINY), lambda sd: from_torch_state_dict(sd, TINY),
              lambda tree: to_torch_state_dict(tree, TINY)),
             (lambda: PatchDiscriminator(**tmp.DISC),
              lambda sd: disc_from_torch_state_dict(sd, num_layers_d=2),
              lambda tree: disc_to_torch_state_dict(tree, num_layers_d=2)))
    for make, to_jax, to_monai in cases:
        torch.manual_seed(0)
        whole = {k: v.clone() for k, v in make().state_dict().items()}
        placed = jax_tp(mesh, to_jax({k: v.numpy() for k, v in whole.items()}))
        # 1 where JAX shards the leaf, carried to MONAI keys by the JAX converter
        flags = jax.tree_util.tree_map(
            lambda x: np.full(x.shape, float(x.sharding.spec != P()), np.float32), placed)
        jax_sharded = {k for k, v in to_monai(flags).items() if v.size and v.max() == 1.0}
        assert jax_sharded
        blocks = {}
        for m in (0, 1):
            fake_rank(m)
            copy = make()
            copy.load_state_dict(whole)
            assert set(tensor_parallel_params(copy)) == jax_sharded
            blocks[m] = dict(copy.named_parameters())
        for name in jax_sharded:
            assert blocks[0][name].shape[0] * 2 == whole[name].shape[0]
            assert torch.equal(torch.cat([blocks[0][name], blocks[1][name]]), whole[name])


@pytest.mark.parametrize("s2d", [False, True])
def test_channel_block_groupnorm_matches_the_whole(fake_rank, s2d):
    """A shard of whole groups runs on its block with G / M groups: the
    whole GroupNorm+SiLU's block of channels."""
    torch.manual_seed(1)
    norm = ae.GroupNormOp(4, 16, 1e-6, silu=True)
    with torch.no_grad():
        norm.weight.add_(0.1 * torch.randn(16))
        norm.bias.add_(0.1 * torch.randn(16))
    x = torch.randn(2, 6, 6, 64 if s2d else 16)
    want = norm(x, s2d)
    for m in (0, 1):
        fake_rank(m)
        copy = ae.GroupNormOp(4, 16, 1e-6, silu=True)
        copy.load_state_dict(norm.state_dict())
        tensor_parallel_params(copy)
        c = x.shape[-1] // 2
        got = copy(x[..., m * c:(m + 1) * c], s2d)
        torch.testing.assert_close(got, want[..., m * c:(m + 1) * c], rtol=1e-5, atol=1e-6)
    set_mesh(None)


def test_state_dicts_cut_and_put_back_together(fake_rank):
    torch.manual_seed(2)
    model = autoencoder_from_config(TINY)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters())
    model(torch.rand(1, 32, 32, 1))[0].sum().backward()
    opt.step()
    opt_whole = opt.state_dict()
    parts = []
    for m in (0, 1):
        fake_rank(m)
        copy = autoencoder_from_config(TINY)
        tensor_parallel_params(copy)
        parts.append((shard_state_dict(copy, whole), shard_optimizer_state(copy, opt_whole),
                      copy.tp_full_shapes))
    full = parts[0][2]
    assert full
    for k, v in whole.items():
        got = torch.cat([parts[0][0][k], parts[1][0][k]]) if k in full else parts[0][0][k]
        assert torch.equal(got, v), k
    names = [n for n, _ in model.named_parameters()]
    for i, entry in opt_whole["state"].items():
        for moment in ("exp_avg", "exp_avg_sq"):
            a, b = (p[1]["state"][i][moment] for p in parts)
            got = torch.cat([a, b]) if names[i] in full else a
            assert torch.equal(got, entry[moment]), (names[i], moment)


@pytest.mark.parametrize("block,world,match", [
    ({"spatial": 2, "tensor": 2}, 4, "mutually exclusive"),
    ({"tensor": 3}, 4, "does not divide 4"),
    ({"spatial": 2, "data": 1}, 4, "data=1 x model=2"),
    ({"spatial": 4}, 4, "shards of 9 rows"),
])
def test_check_parallelism_raises_where_jax_does(block, world, match):
    with pytest.raises(ValueError, match=match):
        check_parallelism(block, world, patch_size=(36, 36), levels=2, s2d=False)


@pytest.mark.parametrize("block,world,s2d,want", [
    ({"tensor": 2}, 2, False, ("tensor", 2, 1)),
    ({"spatial": 2}, 4, False, ("spatial", 2, 2)),
    ({"spatial": 2, "data": 2}, 4, "encoder", ("spatial", 2, 2)),
    ({"data": 4}, 4, False, (None, 1, 4)),
    (None, 1, False, (None, 1, 1)),
])
def test_check_parallelism_accepts_a_full_mesh(block, world, s2d, want):
    assert check_parallelism(block, world, patch_size=(32, 32), levels=2, s2d=s2d) == want


def test_shard_height_condition_counts_levels_and_s2d():
    # 4 levels need tiles of 8 rows, 16 with the s2d forms: 256 / 2 passes, 24 / 2 does not
    check_parallelism({"spatial": 2}, 2, patch_size=(256, 256), levels=4, s2d=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        check_parallelism({"spatial": 2}, 2, patch_size=(24, 24), levels=4, s2d="encoder")
    with pytest.raises(ValueError, match="multiple of 8"):
        check_parallelism({"spatial": 2}, 2, patch_size=(24, 24), levels=4, s2d=False)


@pytest.mark.slow
def test_flagship_widths_at_64_under_tensor_2(tmp_path):
    """The production architecture's widths at 64², batch 4, tensor 2: the
    same step as the toy cases against the port's one process. The loss terms at rtol 1e-4 / atol
    1e-5, the reconstructs at the flagship's bar of ``test_torch_model.py``
    (1e-3 absolute: at this depth the one-pass variance's rounding shows)."""
    flagship = {**tmp.tiny_def((False, False)), "channels": [32, 64, 128, 128],
                "num_res_blocks": 2, "norm_num_groups": 16, "attention_levels": [False] * 4}
    data = tmp.make_inputs(flagship)
    data["images"] = torch.rand(4, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    data["eps"] = torch.randn(4, 8, 8, 2, generator=torch.Generator().manual_seed(1))
    proc, log = tmp.start_launch("tensor", data, tmp_path)
    try:
        one = tmp.port_case(data, None, tmp_path / "one")
    finally:
        ranks = tmp.finish_launch(proc, log, tmp_path)
    for key, want in one.items():
        if key.startswith("metric/"):
            np.testing.assert_allclose(ranks[0][key], want, rtol=1e-4, atol=1e-5, err_msg=key)
        elif key.startswith("recon"):  # the flagship's reconstruct bar (test_torch_model.py)
            assert np.abs(ranks[0][key] - want).max() <= 1e-3, key
