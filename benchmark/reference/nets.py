"""The loss networks, plain: LPIPS over a SqueezeNet-1.1 trunk (MONAI
``PerceptualLoss(network_type="squeeze")``) and the reference trainer's
PatchGAN (MONAI ``PatchDiscriminator(num_layers_d=3, channels=32,
norm="INSTANCE")``). Inputs and outputs NHWC, work NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Ops

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
FIRE = [(16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
        (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)]
LPIPS_CHANNELS = (64, 128, 256, 384, 384, 512, 512)


def lpips_spec() -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, role) of the LPIPS tree, flattened with ``/``: conv
    weights OIHW, ``lin`` weights per channel."""
    spec = [("conv0/w", (64, 3, 3, 3), "he"), ("conv0/b", (64,), "zero")]
    cin = 64
    for i, (s, e1, e3) in enumerate(FIRE):
        spec += [(f"fire{i}/squeeze/w", (s, cin, 1, 1), "he"), (f"fire{i}/squeeze/b", (s,), "zero"),
                 (f"fire{i}/expand1/w", (e1, s, 1, 1), "he"), (f"fire{i}/expand1/b", (e1,), "zero"),
                 (f"fire{i}/expand3/w", (e3, s, 3, 3), "he"), (f"fire{i}/expand3/b", (e3,), "zero")]
        cin = e1 + e3
    spec += [(f"lin{i}/w", (c,), "lin") for i, c in enumerate(LPIPS_CHANNELS)]
    return spec


def lpips_per_sample(ops: Ops, L: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B] LPIPS distances of NHWC 1- or 3-channel batches ``x`` and ``y``."""
    b = x.shape[0]
    both = torch.cat([x, y]).float()
    if both.shape[-1] == 1:
        both = both.expand(*both.shape[:-1], 3)
    shift = torch.tensor(LPIPS_SHIFT, device=x.device)
    scale = torch.tensor(LPIPS_SCALE, device=x.device)
    h = ((both - shift) / scale).permute(0, 3, 1, 2)

    def conv(h, name, **kw):
        return F.relu(ops.conv(h, L[f"{name}/w"], L[f"{name}/b"], **kw))

    def fire(h, i):
        s = conv(h, f"fire{i}/squeeze")
        return torch.cat([conv(s, f"fire{i}/expand1"), conv(s, f"fire{i}/expand3", padding=1)], 1)

    def pool(h):
        return F.max_pool2d(h, kernel_size=3, stride=2, ceil_mode=True)

    taps = []
    h = conv(h, "conv0", stride=2)
    taps.append(h)
    h = fire(fire(pool(h), 0), 1)
    taps.append(h)
    h = fire(fire(pool(h), 2), 3)
    taps.append(h)
    h = pool(h)
    for i in range(4, 8):
        h = fire(h, i)
        taps.append(h)
    total = torch.zeros(b, device=x.device)
    for i, t in enumerate(taps):
        t = t / (t.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
        diff = (t[:b] - t[b:]).square()
        total = total + (diff * L[f"lin{i}/w"][None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total


def disc_spec(layers: int = 3, channels: int = 32) -> list[tuple[str, tuple[int, ...], str]]:
    """(MONAI name, shape, role) of the PatchGAN: 4x4 convolutions, biases on
    the first and the last only."""
    spec = [("initial_conv.conv.weight", (channels, 1, 4, 4), "disc"),
            ("initial_conv.conv.bias", (channels,), "zero")]
    ch = channels
    for layer in range(layers):
        spec.append((f"{layer}.conv.weight", (ch * 2, ch, 4, 4), "disc"))
        ch *= 2
    return spec + [("final_conv.conv.weight", (1, ch, 4, 4), "disc"),
                   ("final_conv.conv.bias", (1,), "zero")]


def disc_logits(ops: Ops, D: dict, x: torch.Tensor, layers: int = 3) -> torch.Tensor:
    """The PatchGAN's logits map, NCHW, of an NHWC batch: conv s2 + LeakyReLU
    0.2, then ``layers`` convs (stride 2, the last 1) each with InstanceNorm
    (eps 1e-5, no affine) + LeakyReLU, then a stride-1 conv to one channel."""
    h = F.leaky_relu(ops.conv(x.permute(0, 3, 1, 2), D["initial_conv.conv.weight"],
                              D["initial_conv.conv.bias"], stride=2, padding=1), 0.2)
    for layer in range(layers):
        h = ops.conv(h, D[f"{layer}.conv.weight"], None, stride=2 if layer < layers - 1 else 1,
                     padding=1)
        h = F.leaky_relu(ops.q(F.instance_norm(h, eps=1e-5)), 0.2)
    return ops.conv(h, D["final_conv.conv.weight"], D["final_conv.conv.bias"], padding=1)
