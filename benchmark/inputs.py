"""What the benchmark makes from ``--seed`` and hands to both sides: the raw
images and their attributes, the TIF files the program's loaders read, and
every weight (the autoencoder's, the discriminator's, LPIPS' features).

Everything is drawn on the run's device by one ``torch.Generator`` per kind,
in a few large calls, so a seed gives the same values on every run and the
reference can draw them again instead of taking the program's copy.
"""

from __future__ import annotations

import hashlib
import json
import math
import struct
from pathlib import Path

import numpy as np
import torch

from .reference.nets import disc_spec, lpips_spec
from .reference.vae import param_spec


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one kind of input of a run."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def raw_images(n: int, hw: tuple[int, int], seed: int, device: torch.device,
               chunk: int = 256) -> torch.Tensor:
    """[n, H, W] float32 radiograph-like images: an elliptic field of view
    (zero outside, as the loaders' masked z-score expects) holding a smooth
    structured intensity with grain, each image with its own ellipse (a
    third to all of the frame), orientation, frequencies, level and grain
    (dose) level, so that images differ as much as patients' do."""
    g = generator(seed, "images", device)
    params = torch.rand((n, 9), generator=g, device=device)
    h, w = hw
    yy = torch.linspace(-1.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(-1.0, 1.0, w, device=device)[None, :]
    out = torch.empty((n, h, w), device=device)
    for start in range(0, n, chunk):
        p = params[start:start + chunk, :, None, None]
        grain = torch.rand((p.shape[0], h, w), generator=g, device=device)
        angle = (p[:, 4] - 0.5) * math.pi / 3
        cos, sin = torch.cos(angle), torch.sin(angle)
        x0, y0 = xx - 0.2 * (p[:, 0] - 0.5), yy - 0.2 * (p[:, 1] - 0.5)
        xr, yr = x0 * cos + y0 * sin, y0 * cos - x0 * sin
        inside = ((xr / (0.35 + 0.6 * p[:, 2])).square()
                  + (yr / (0.3 + 0.65 * p[:, 3])).square() <= 1.0)
        freq = 1.0 + 19.0 * p[:, 5]
        field = 0.55 + 0.3 * torch.sin(freq * xr + 6.28 * p[:, 6]) * torch.cos(0.7 * freq * yr)
        level = 0.2 + 0.8 * p[:, 7]
        dose = 0.02 + 0.58 * p[:, 8]
        out[start:start + chunk] = torch.where(inside, level * field + dose * grain, 0.0)
    return out


def attributes(n: int, names: list[str], seed: int, device: torch.device) -> torch.Tensor:
    """[n, A] float32 attribute values (standard normal: no two alike)."""
    return torch.randn((n, len(names)), generator=generator(seed, "attributes", device),
                       device=device)


def write_tif(path: Path, image: np.ndarray) -> None:
    """A float32 grayscale TIFF: little-endian, one uncompressed strip."""
    h, w = image.shape
    entries = [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1), (262, 3, 1), (273, 4, 0),
               (277, 3, 1), (278, 4, h), (279, 4, h * w * 4), (284, 3, 1), (339, 3, 3)]
    offset = 8 + 2 + 12 * len(entries) + 4
    ifd = [struct.pack("<H", len(entries))]
    for tag, typ, value in entries:
        value = offset if tag == 273 else value
        packed = struct.pack("<I", value) if typ == 4 else struct.pack("<HH", value, 0)
        ifd.append(struct.pack("<HHI", tag, typ, 1) + packed)
    ifd.append(struct.pack("<I", 0))
    with open(path, "wb") as fh:
        fh.write(b"II" + struct.pack("<HI", 42, 8) + b"".join(ifd))
        fh.write(np.ascontiguousarray(image, dtype="<f4").tobytes())


def image_name(i: int) -> str:
    return f"img_{i:05d}.tif"


def write_dataset(folder: Path, raw: torch.Tensor, attrs: torch.Tensor | None,
                  attr_names: list[str]) -> Path | None:
    """The images as ``folder/img_NNNNN.tif`` and, with attributes, a JSON
    file ``{file name: {attribute: value}}`` beside them; returns its path."""
    folder.mkdir(parents=True, exist_ok=True)
    host = raw.cpu().numpy()
    for i, image in enumerate(host):
        write_tif(folder / image_name(i), image)
    if attrs is None:
        return None
    values = attrs.cpu().numpy()
    table = {image_name(i): {k: float(v) for k, v in zip(attr_names, row)}
             for i, row in enumerate(values)}
    path = folder.parent / "attributes.json"
    path.write_text(json.dumps(table))
    return path


def _draw(spec: list[tuple[str, tuple[int, ...], str]], seed: int, tag: str,
          device: torch.device) -> dict[str, torch.Tensor]:
    """Every leaf of ``spec`` from one normal and one uniform draw, scaled by
    its role: ``conv`` / ``linear`` 1/sqrt(fan-in), ``he`` sqrt(2/fan-in),
    ``bias`` and ``disc`` 0.02, ``norm_w`` 1 + 0.1 n, ``norm_b`` 0.1 n, ``lin``
    uniform in [0, 2/C), ``zero`` zeros. ``logvar``, the log-variance
    projection, 0.1/sqrt(fan-in): the posterior's sigma stays near 1, as in a
    trained model, where the reference objective takes exp(sigma) (at the
    fan-in scale sigma reaches 5-11 and exp(sigma) turns each bfloat16
    rounding of the log-variance into a percent of the KL term)."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    g = generator(seed, tag, device)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, role in spec:
        size = math.prod(shape)
        n, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        out[name] = {
            "conv": lambda: n / math.sqrt(fan_in), "linear": lambda: n / math.sqrt(fan_in),
            "logvar": lambda: 0.1 * n / math.sqrt(fan_in),
            "he": lambda: n * math.sqrt(2.0 / fan_in), "bias": lambda: 0.02 * n,
            "disc": lambda: 0.02 * n, "norm_w": lambda: 1.0 + 0.1 * n,
            "norm_b": lambda: 0.1 * n, "lin": lambda: u * (2.0 / shape[0]),
            "zero": lambda: torch.zeros_like(n),
        }[role]().contiguous()
    return out


def vae_weights(ae: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    return _draw(param_spec(ae), seed, "vae", device)


def disc_weights(seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    return _draw(disc_spec(), seed, "disc", device)


def lpips_weights(seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Flat ``a/b/c`` names (the program takes them as the nested tree)."""
    return _draw(lpips_spec(), seed, "lpips", device)


def nested(flat: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
