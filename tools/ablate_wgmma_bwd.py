#!/usr/bin/env python3
"""Where the two tensor-core backward kernels' time goes, by leaving parts out.

    python3 tools/ablate_wgmma_bwd.py        # needs one CUDA card and nvcc

Builds ``csrc/flash_attention_bwd_wgmma.cu`` and ``csrc/conv3x3_wgrad_wgmma.cu``
as they are and in variants whose results are wrong on purpose (copies of the
sources under ``build/ablate_bwd/``, edited by string replacement; the
package's own libraries are untouched):

- ``no_copies``: no tile is copied after the ones the prologue starts, so the
  products run on stale tiles: what is left is products, barriers and the
  arithmetic between them;
- ``no_products``: no ``wgmma`` is issued, so what is left is the copies,
  barriers and the arithmetic between products;
- ``neither``: both left out: the launch, barriers, waits, index arithmetic
  (and, for the attention, the softmax-side arithmetic on stale registers).

Prints one JSON line per shape with the device time (ms, summed kernel time
of ``torch.profiler``, 20 calls, L2 warm) of each variant: the attention
backward's main kernel alone (its delta pre-pass is the same in every
variant) at the head dims of ``FLASH_SHAPES``, the filter gradient at the
warpgroups and slab count the wrapper picks. Parts whose times add up do not overlap; if
``as_it_is`` is close to ``no_products``, the copies bound the kernel.
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

FLASH_SHAPES = [(8, 1, 1024, 128), (8, 1, 1024, 64), (8, 1, 1024, 16)]
WGRAD_SHAPES = [(8, 256, 256, 32, 32), (8, 128, 128, 64, 64), (8, 64, 64, 128, 128),
                (8, 32, 32, 128, 128)]
SKIP = "template <typename... A> __device__ __forceinline__ void ablate_skip(A&&...) {}\n"


def _replace(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"the source no longer holds exactly {count} of {old!r}")
    return text.replace(old, new)


def _skip_products(text: str, calls: tuple[str, ...]) -> str:
    text = _replace(text, "namespace {\n", "namespace {\n" + SKIP)
    for call in calls:
        text = text.replace(call, "ablate_skip(")
    return text


FLASH_CALLS = ("WgmmaSS<64, 0, 0>::run(", "WgmmaRS<D>::run(")


def flash_no_copies(text: str) -> str:
    text = _replace(text, "    stage_q(t + kStages - 1);  // into the slot tile t-1 left\n", "")
    return _replace(text, "    stage_kv(t + kStages - 1);\n", "")


def flash_no_products(text: str) -> str:
    return _skip_products(text, FLASH_CALLS)


WGRAD_CALLS = ("WgmmaSS<NT, 1, 1>::run(",)


def wgrad_no_copies(text: str) -> str:
    return _replace(text, "    if (s >= n_steps) return;", "    if (s >= 2 || s >= n_steps) return;")


def wgrad_no_products(text: str) -> str:
    return _skip_products(text, WGRAD_CALLS)


VARIANTS = {
    "flash_attention_bwd_wgmma.cu": {
        "as_it_is": lambda t: t, "no_copies": flash_no_copies, "no_products": flash_no_products,
        "neither": lambda t: flash_no_products(flash_no_copies(t))},
    "conv3x3_wgrad_wgmma.cu": {
        "as_it_is": lambda t: t, "no_copies": wgrad_no_copies, "no_products": wgrad_no_products,
        "neither": lambda t: wgrad_no_products(wgrad_no_copies(t))},
}


def build_variants(_build) -> dict[str, dict[str, ctypes.CDLL]]:
    out = _build.BUILD_DIR / "ablate_bwd"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC_DIR / "hopper_mma.cuh", out / "hopper_mma.cuh")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = []
    for source, variants in VARIANTS.items():
        text = (_build.CSRC_DIR / source).read_text()
        for name, edit in variants.items():
            path = out / f"{source.removesuffix('.cu')}_{name}.cu"
            path.write_text(edit(text))
            procs.append((source, name, path, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(path.with_suffix(".so")), str(path)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {source: {} for source in VARIANTS}
    for source, name, path, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the variant {name} of {source}:\n{err[-2000:]}")
        libs[source][name] = ctypes.CDLL(str(path.with_suffix(".so")))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_wgmma_bwd: no CUDA device", file=sys.stderr)
        return 2
    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import wgrad_warpgroups, wgrad_wgmma_slabs
    from tools.check_wgmma_kernels import device_ms

    libs = build_variants(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    for shape in FLASH_SHAPES:
        b, h, s, d = shape
        q, k, v, out, g = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(5))
        lse = torch.randn(b, h, s, device="cuda", generator=gen).abs() + 5.0
        delta = torch.empty(b, h, s, device="cuda")
        grads = [torch.empty_like(q) for _ in range(3)]
        times = {}
        for name, lib in libs["flash_attention_bwd_wgmma.cu"].items():
            fn = lib.flash_attention_bwd_wgmma
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
            ptrs = [t.data_ptr() for t in (q, k, v, out, g, lse, delta, *grads)]
            times[name] = round(device_ms(torch, lambda: fn(*ptrs, b * h, s, d, d ** -0.5, stream)), 4)
        print(json.dumps({"kernel": "flash_attention_bwd_wgmma", "shape": list(shape),
                          "device_ms_with_delta_prepass": times}), flush=True)

    for shape in WGRAD_SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        g = torch.randn(b, h, w, cout, device="cuda", generator=gen).bfloat16()
        wg = wgrad_warpgroups(cout)
        n_slab = wgrad_wgmma_slabs(shape, wg, n_sm)
        partials = torch.empty(n_slab, 9 * cin, cout, device="cuda")
        times = {}
        for name, lib in libs["conv3x3_wgrad_wgmma.cu"].items():
            fn = lib.conv3x3_wgrad_wgmma
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            times[name] = round(device_ms(torch, lambda: fn(
                x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w, cin, cout, n_slab, wg,
                stream)), 4)
        print(json.dumps({"kernel": "conv3x3_wgrad_wgmma", "shape": list(shape), "warpgroups": wg,
                          "slabs": n_slab, "device_ms_without_fold": times}), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
