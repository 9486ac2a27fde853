"""The port's ``instance_norm``, ``PatchDiscriminator`` and LSGAN losses
against the JAX package, f32 on the CPU, from the same numpy inputs and the
JAX parameters carried across by ``disc_state_dict_from_flax``.

Bars: rtol 1e-4 / atol 1e-5 for every feature map and loss (summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import disc_to_torch_state_dict
from pti_ldm_vae_tpu.losses import adversarial as jax_adv
from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from pti_ldm_vae_tpu.ops.norm import instance_norm as jax_instance_norm
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    disc_monai_layout,
    disc_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.losses import adversarial as adv
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.ops.norm import instance_norm

TOL = dict(rtol=1e-4, atol=1e-5)
MONAI_KEYS = ["initial_conv.conv.weight", "initial_conv.conv.bias", "0.conv.weight",
              "1.conv.weight", "2.conv.weight", "final_conv.conv.weight", "final_conv.conv.bias"]


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 5, 7, 6), (2, 16, 3), (1, 4, 4, 4, 2)],
                         ids=["2d", "2d_ragged", "1d", "3d"])
def test_instance_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3.0 + 1.5).astype(np.float32)
    want = np.asarray(jax_instance_norm(jnp.asarray(x)))
    got = instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # per sample and channel: zero mean, unit (biased) variance up to eps
    flat = got.reshape(shape[0], -1, shape[-1])
    assert float(flat.mean(dim=1).abs().max()) < 1e-5
    assert float((flat.var(dim=1, unbiased=False) - 1.0).abs().max()) < 1e-3


def test_instance_norm_affine_and_dtype():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    scale, bias = rng.normal(size=(3,)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)
    want = np.asarray(jax_instance_norm(jnp.asarray(x), eps=1e-3, scale=jnp.asarray(scale),
                                        bias=jnp.asarray(bias)))
    got = instance_norm(torch.from_numpy(x), eps=1e-3, scale=torch.from_numpy(scale),
                        bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert instance_norm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_instance_norm_gradient_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    g = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_instance_norm(a) * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (instance_norm(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jax_disc = JaxPatchDiscriminator(spatial_dims=2, num_layers_d=3, channels=8)
    variables = jax.jit(jax_disc.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 1)))
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    # larger weights and non-zero biases than the 0.02 init, so every layer matters
    leaves = [np.asarray(a) * 5.0 + 0.05 * rng.normal(size=a.shape).astype(np.float32)
              for a in leaves]
    variables = jax.tree_util.tree_unflatten(treedef, leaves)
    port = PatchDiscriminator(channels=8)
    port.load_state_dict(disc_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)),
                         strict=True)
    x = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    return jax_disc, variables, port, x


def test_discriminator_feature_maps_match_jax(pair):
    jax_disc, variables, port, x = pair
    want = jax_disc.apply(variables, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    assert [tuple(f.shape) for f in got] == [(2, 32, 32, 8), (2, 16, 16, 16), (2, 8, 8, 32),
                                             (2, 7, 7, 64), (2, 6, 6, 1)]
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **TOL)
    assert got[-1].dtype == torch.float32


def test_discriminator_gradients_match_jax_by_monai_key(pair):
    jax_disc, variables, port, x = pair

    def loss(params, xa):
        return jnp.mean(jnp.square(jax_disc.apply(params, xa)[-1] - 1.0))

    grads, gx = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    want = disc_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    xt = torch.from_numpy(x).requires_grad_()
    port.zero_grad()
    adv.generator_loss(port(xt)[-1]).backward()
    assert {k for k, _ in port.named_parameters()} == set(want)
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key], rtol=1e-3,
                                   atol=1e-4 * float(np.abs(want[key]).max()), err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4 * float(np.abs(np.asarray(gx)).max()))
    port.zero_grad()


def test_discriminator_has_monai_keys_and_loads_a_reference_state_dict_strictly():
    disc = PatchDiscriminator()
    assert list(disc.state_dict()) == MONAI_KEYS
    assert [f"{prefix}.weight" for _, prefix, _ in disc_monai_layout(3)] == \
        [k for k in MONAI_KEYS if k.endswith("weight")]
    shapes = {k: tuple(v.shape) for k, v in disc.state_dict().items()}
    assert shapes["initial_conv.conv.weight"] == (32, 1, 4, 4)
    assert shapes["2.conv.weight"] == (256, 128, 4, 4) and shapes["final_conv.conv.weight"] == (1, 256, 4, 4)
    # a reference-layout file: MONAI's keys, saved raw
    rng = np.random.default_rng(4)
    reference = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    disc.load_state_dict(reference, strict=True)
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        disc.load_state_dict({**reference, "1.conv.bias": torch.zeros(128)}, strict=True)


def test_discriminator_init_is_seeded_normal_002():
    a = PatchDiscriminator(generator=torch.Generator().manual_seed(5))
    b = PatchDiscriminator(generator=torch.Generator().manual_seed(5))
    c = PatchDiscriminator(generator=torch.Generator().manual_seed(6))
    for key, p in a.state_dict().items():
        assert torch.equal(p, b.state_dict()[key])
        if key.endswith("bias"):
            assert float(p.abs().max()) == 0.0
        else:
            assert not torch.equal(p, c.state_dict()[key])
    w = a.state_dict()["2.conv.weight"]
    assert float(w.std()) == pytest.approx(0.02, rel=0.02) and abs(float(w.mean())) < 1e-3


@pytest.mark.parametrize("spatial_dims", [1, 3, 4])
def test_discriminator_spatial_dims(spatial_dims):
    """Rank 1 and 3 build and give the patch map of the JAX package's
    ``test_discriminator_3d_patch_output`` (held to it in
    ``tests/test_torch_spatial_dims.py``); rank 4 is a ``ValueError``, as there."""
    if spatial_dims == 4:
        with pytest.raises(ValueError, match="spatial_dims"):
            PatchDiscriminator(spatial_dims=spatial_dims)
        return
    disc = PatchDiscriminator(spatial_dims=spatial_dims, num_layers_d=2, channels=4,
                              generator=torch.Generator().manual_seed(0))
    feats = disc(torch.ones(2, *(16,) * spatial_dims, 1))
    assert feats[-1].shape == (2, *(2,) * spatial_dims, 1) and len(feats) == 4


def test_discriminator_bf16_compute_keeps_f32_logits_and_parameters():
    disc = PatchDiscriminator(channels=8, compute_dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(7))
    feats = disc(torch.randn(1, 32, 32, 1))
    assert [f.dtype for f in feats] == [torch.bfloat16] * 4 + [torch.float32]
    feats[-1].sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in disc.parameters())


def test_lsgan_losses_match_jax():
    rng = np.random.default_rng(8)
    fake = rng.normal(size=(3, 6, 6, 1)).astype(np.float32)
    real = rng.normal(size=(3, 6, 6, 1)).astype(np.float32) + 1.0
    for ours, theirs, args in [
        (adv.lsgan_loss, jax_adv.lsgan_loss, (fake, True)),
        (adv.lsgan_loss, jax_adv.lsgan_loss, (fake, False)),
        (adv.generator_loss, jax_adv.generator_loss, (fake,)),
        (adv.discriminator_loss, jax_adv.discriminator_loss, (fake, real)),
    ]:
        got = ours(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
        want = theirs(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert adv.lsgan_loss(torch.from_numpy(fake).bfloat16(), True).dtype == torch.float32
