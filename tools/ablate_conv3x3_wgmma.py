#!/usr/bin/env python3
"""Where the tensor-core convolution kernel's time goes, by leaving parts out.

    python3 tools/ablate_conv3x3_wgmma.py        # needs one CUDA card and nvcc

Builds ``csrc/conv3x3_wgmma.cu`` as it is and in variants whose results are
wrong on purpose (copies of the source under ``build/ablate/``, edited by
string replacement; the package's own library is untouched):

- ``one_tap``: one of the nine taps, so 1/9 of the wgmma products;
- ``no_halo``: no halo copies after the first two steps of a block;
- ``no_store``: the epilogue stores nothing;
- ``one_tap+no_halo``, ``none_of_them``: the combinations, down to what is left:
  the weight slab's copy, barriers, waits and index arithmetic;
- ``no_slab``: the weight slab is not copied; ``none_of_them+no_slab``: what is
  left then: the launch, barriers, waits and index arithmetic.

Prints one JSON line per shape (the flagship's, then the kl1e3 model's
256-channel ones, on 32 output columns a block) with the device time (ms,
summed kernel time of ``torch.profiler``, 20 calls, L2 warm) of each variant
at the tile ``wgmma_tile`` picks. Parts whose times add up do not overlap.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [(8, 256, 256, 32, 32), (8, 128, 128, 128, 128), (8, 64, 64, 128, 128),
          (8, 32, 32, 128, 128), (8, 256, 256, 64, 64), (8, 128, 128, 64, 64),
          (8, 64, 64, 256, 256), (8, 128, 128, 256, 256), (8, 128, 128, 256, 128)]


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old!r}")
    return text.replace(old, new)


def one_tap(text: str) -> str:
    # the loop over taps of the products (the slab's copy has one of its own)
    return _replace(text, "for (int tap = 0; tap < 9; ++tap) {\n        const int ky",
                    "for (int tap = 0; tap < 1; ++tap) {\n        const int ky")


def no_halo(text: str) -> str:
    return _replace(text, "if (s >= n_steps) return;", "if (s >= 2) return;")


def no_store(text: str) -> str:
    return _replace(text, "if (gh >= h || gw >= w || co >= cout) continue;", "if (gh >= 0) continue;")


def no_slab(text: str) -> str:
    return _replace(text, "auto stage_weights = [&](int first, int last) {",
                    "auto stage_weights = [&](int first, int last) {\n    if (first >= 0) return;")


VARIANTS = {
    "as_it_is": lambda t: t,
    "one_tap": one_tap,
    "no_halo": no_halo,
    "no_store": no_store,
    "one_tap+no_halo": lambda t: one_tap(no_halo(t)),
    "none_of_them": lambda t: one_tap(no_halo(no_store(t))),
    "no_slab": no_slab,
    "none_of_them+no_slab": lambda t: no_slab(one_tap(no_halo(no_store(t)))),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_conv3x3_wgmma: no CUDA device", file=sys.stderr)
        return 2
    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import wgmma_tile
    from tools.check_wgmma_kernels import device_ms

    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC_DIR / "hopper_mma.cuh", out / "hopper_mma.cuh")
    source = (_build.CSRC_DIR / "conv3x3_wgmma.cu").read_text()
    builds = []
    for name, edit in VARIANTS.items():
        path = out / f"{name.replace('+', '_')}.cu"
        path.write_text(edit(source))
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        builds.append((name, path, subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)))
    libs = {}
    for name, path, proc in builds:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the variant {name}")
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        lib.conv3x3_wgmma_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        libs[name] = lib

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        wmat = (torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5).bfloat16()
        y = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)
        mt, tn, kc = wgmma_tile(b, h, w, cin, cout, n_sm)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: round(device_ms(torch, lambda: lib.conv3x3_wgmma_fwd(
            x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin, cout, cout, mt, tn, kc,
            stream)), 4) for name, lib in libs.items()}
        print(json.dumps({"shape": list(shape), "tile": [mt, tn, kc], "device_ms": times}), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
