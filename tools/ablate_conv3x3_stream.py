#!/usr/bin/env python3
"""Where the streamed-weight convolution kernel's time goes, by leaving parts out.

    python3 tools/ablate_conv3x3_stream.py        # needs one CUDA card and nvcc

Builds ``csrc/conv3x3_stream_wgmma.cu`` as it is and in variants whose
results are wrong on purpose (copies of the source under ``build/ablate/``,
edited by string replacement; the package's own library is untouched). A
variant that leaves a load out still arrives on the stage's full barrier, so
the pipeline runs as before on whatever the stage holds:

- ``no_weights``: no weight tile is loaded (the L2 traffic a cluster multicast
  would halve);
- ``no_halo``: no halo stage is loaded;
- ``no_loads``: neither: the products, barriers and stores alone;
- ``one_tap``: the products of one tap of nine, the loads all made;
- ``no_store``: the epilogue stores nothing;
- ``none_of_them``: no loads, one tap, no store: the barriers, waits and
  index arithmetic that are left.

Prints one JSON line per shape (the kl1e3 model's calls that stream their
weights, and Cin 512) with the device time (ms, summed kernel time of
``torch.profiler``, 20 calls, L2 warm) of each variant. Where ``no_weights``
reads about as ``as_it_is``, the weight traffic from L2 does not bound the
kernel.
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

SHAPES = [(8, 64, 64, 256, 256), (8, 128, 128, 256, 256), (8, 128, 128, 256, 128),
          (8, 64, 64, 256, 128), (8, 32, 32, 512, 512)]


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old!r}")
    return text.replace(old, new)


def no_weights(text: str) -> str:
    return _replace(text, "mbar_expect_tx(w_full(ws), kWeightStageBytes);\n"
                          "            for (int half = 0; half < kTileN / 64; ++half)",
                    "mbar_arrive(w_full(ws));\n"
                    "            for (int half = 0; half < 0; ++half)")


def no_halo(text: str) -> str:
    return _replace(text, "mbar_expect_tx(halo_full(hs), kPlanes * kPlaneBox);\n"
                          "          for (int p = 0; p < kPlanes; ++p)",
                    "mbar_arrive(halo_full(hs));\n"
                    "          for (int p = 0; p < 0; ++p)")


def one_tap(text: str) -> str:
    return _replace(text, "for (int kk = 0; kk < kChunk / 16; ++kk) {",
                    "for (int kk = 0; kk < (tap == 0 ? kChunk / 16 : 0); ++kk) {")


def no_store(text: str) -> str:
    return _replace(text, "if (!live || co >= cout) continue;", "if (co >= 0) continue;")


VARIANTS = {
    "as_it_is": lambda t: t,
    "no_weights": no_weights,
    "no_halo": no_halo,
    "no_loads": lambda t: no_weights(no_halo(t)),
    "one_tap": one_tap,
    "no_store": no_store,
    "none_of_them": lambda t: no_store(one_tap(no_weights(no_halo(t)))),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_conv3x3_stream: no CUDA device", file=sys.stderr)
        return 2
    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from tools.check_wgmma_kernels import device_ms

    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC_DIR / "hopper_mma.cuh", out / "hopper_mma.cuh")
    source = (_build.CSRC_DIR / "conv3x3_stream_wgmma.cu").read_text()
    builds = []
    for name, edit in VARIANTS.items():
        path = out / f"stream_{name}.cu"
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
        lib.conv3x3_stream_wgmma_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        wmat = (torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5).bfloat16()
        y = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: round(device_ms(torch, lambda: lib.conv3x3_stream_wgmma_fwd(
            x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin, cout, cout, stream)), 4)
            for name, lib in libs.items()}
        bound_ms = 2 * 9 * cin * cout * b * h * w / 989e12 * 1e3
        print(json.dumps({"shape": list(shape), "bound_ms": round(bound_ms, 4), "device_ms": times}),
              flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
