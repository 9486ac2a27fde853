#!/usr/bin/env python3
"""Quick check of the four tensor-core kernels on one CUDA card.

    python3 tools/check_wgmma_kernels.py [--time] [--tiles]

Builds ``csrc/conv3x3_wgmma.cu``, ``csrc/flash_attention_wgmma.cu``,
``csrc/conv3x3_wgrad_wgmma.cu`` and ``csrc/flash_attention_bwd_wgmma.cu``
(and the f32-FMA kernels beside them; a few seconds), prints what ``ptxas``
reports for the four, and holds each against its plain PyTorch version at the
flagship path's shapes and at ragged ones: the forward kernels and the
attention backward in bf16 at atol 2e-2 on the same rounded inputs, the filter
gradient (f32 sums of exact products) at rtol 1e-4 / atol 1e-5 * sqrt(B*H*W);
both backward kernels also twice, for the same bits. With ``--time`` it also
prints device times per call (``torch.profiler``, L2 warm) beside the f32-FMA
kernels' and the library calls'. One JSON object per line; exits non-zero at
the first disagreement, after printing where the largest errors lie. With
``--tiles`` the convolution forward is also timed (and compared) at every
tile that fits, and the filter gradient with one and two warpgroups per
block at several slab counts, with the worst error over the bar and the mean signed
error against a float64 reference (the error that grows with the length of
an accumulation chain). ``chip_smoke.py`` is the full run.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CONV_SHAPES = [(1, 8, 8, 16, 8), (1, 8, 8, 16, 64), (1, 16, 32, 32, 32), (2, 37, 70, 24, 40),
               (8, 32, 32, 128, 128), (8, 32, 32, 128, 4), (8, 64, 64, 128, 128),
               (8, 128, 128, 64, 64), (8, 256, 256, 32, 32), (8, 256, 256, 64, 32),
               (8, 128, 128, 128, 128), (8, 256, 256, 64, 64)]
FLASH_SHAPES = [(1, 1, 64, 16), (1, 1, 64, 128), (2, 2, 200, 32), (2, 2, 1000, 64),
                (8, 1, 1024, 16), (8, 1, 1024, 32), (8, 1, 1024, 64), (8, 1, 1024, 128),
                (2, 1, 200, 128), (1, 3, 77, 32)]
# the filter gradient's shapes on the tensor-core kernel: the flagship's fourteen (the four
# thin ones padded to 8 channels), ragged ones
WGRAD_SHAPES = [(1, 8, 8, 8, 8), (2, 37, 70, 24, 40), (1, 11, 19, 72, 16), (1, 20, 12, 3, 5),
                (8, 256, 256, 1, 32), (8, 256, 256, 32, 1), (8, 32, 32, 128, 4), (8, 32, 32, 4, 128),
                (8, 32, 32, 128, 128),
                (8, 64, 64, 128, 128), (8, 64, 64, 64, 128), (8, 128, 128, 32, 64),
                (8, 128, 128, 64, 64), (8, 128, 128, 128, 64), (8, 128, 128, 128, 128),
                (8, 256, 256, 32, 32), (8, 256, 256, 64, 32), (8, 256, 256, 64, 64)]
WGMMA_SOURCES = ("conv3x3_wgmma.cu", "flash_attention_wgmma.cu", "conv3x3_wgrad_wgmma.cu",
                 "flash_attention_bwd_wgmma.cu")


def emit(**fields) -> None:
    print(json.dumps(fields, separators=(",", ":")), flush=True)


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of ``fn()``: the summed time of its kernels in a
    ``torch.profiler`` trace (no launch overhead, no L2 flush between calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device kernel in three traces")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("check_wgmma_kernels: no CUDA device", file=sys.stderr)
        return 2
    from pti_ldm_vae_tpu_torch.ops.kernels import _build

    # the package re-exports the wrappers under the modules' names
    conv_mod = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.conv3x3")
    flash_mod = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.flash_attention")

    timed = "--time" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = _build.build_all((*WGMMA_SOURCES, "conv3x3.cu", "flash_attention.cu",
                             "flash_attention_bwd.cu", "conv3x3_wgrad.cu"))
    for lib in libs[:len(WGMMA_SOURCES)]:
        log = lib.with_suffix(".log").read_text().splitlines()
        keep = [ln for ln in log if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
        emit(library=lib.name, ptxas=[ln for ln in keep if "injected" not in ln][:80],
             injected_waits=sum("injected" in ln for ln in keep))

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape in CONV_SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        wmat = (torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5).bfloat16()
        assert conv_mod.forward_kernel(x.dtype, cin) == "wgmma"
        got = conv_mod._launch_forward(x, wmat).float()
        torch.cuda.synchronize()
        want = conv_mod.conv3x3_plain(x.float(), wmat.float())
        err = (got - want).abs()
        row = {"conv3x3_wgmma": list(shape), "max_abs_err": float(err.max())}
        if not float(err.max()) <= 2e-2:
            ok = False
            bad = (err > 2e-2).nonzero()
            row.update(bad_share=float((err > 2e-2).float().mean()), first_bad=bad[:12].tolist(),
                       got=[float(got[tuple(i)]) for i in bad[:6]],
                       want=[float(want[tuple(i)]) for i in bad[:6]])
        if timed:
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = (wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last))
            fma = conv_mod._forward_library()
            y = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)
            stream = torch.cuda.current_stream().cuda_stream
            row.update(ms=device_ms(torch, lambda: conv_mod._launch_forward(x, wmat)),
                       fma_ms=device_ms(torch, lambda: fma.conv3x3_fwd(
                           x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin, cout, 1, stream)),
                       library_ms=device_ms(torch, lambda: F.conv2d(x_lib, w_lib, padding=1)))
        if "--tiles" in sys.argv[1:]:  # every tile that fits, beside the one ``wgmma_tile`` picks
            lib = conv_mod._wgmma_library()
            y = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)
            wpad = conv_mod.pad_columns(wmat)
            stream = torch.cuda.current_stream().cuda_stream
            picked = conv_mod.wgmma_tile(b, h, w, cin, cout, 132)
            by_tile = {}
            for kc in (16, 32, 64):
                for mt in (4, 2, 1):
                    if kc > max(cin, 16) or conv_mod.wgmma_smem_bytes(cin, mt, picked[1], kc) > 232448:
                        continue
                    by_tile[f"mt{mt} kc{kc}"] = device_ms(torch, lambda: lib.conv3x3_wgmma_fwd(
                        x.data_ptr(), wpad.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
                        wpad.shape[1], mt, picked[1], kc, stream))
                    torch.cuda.synchronize()
                    if not torch.equal(y.float(), got):
                        raise RuntimeError(f"{shape} mt{mt} kc{kc}: differs from the picked tile's result")
            row.update(picked=list(picked), ms_by_tile=by_tile)
        emit(**row)
        if not ok:
            return 1

    for shape in FLASH_SHAPES:
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(4))
        scale = shape[-1] ** -0.5
        out, lse = flash_mod._launch_forward(q, k, v, True, scale)
        torch.cuda.synchronize()
        want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float())
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        err = (out.float() - want).abs()
        lse_err = float((lse - torch.logsumexp(scores, dim=-1)).abs().max())
        assert flash_mod.backward_kernel(q.dtype, shape[-1]) == "wgmma"
        grads = flash_mod._launch_backward(q, k, v, out, lse, g, scale)
        again = flash_mod._launch_backward(q, k, v, out, lse, g, scale)
        torch.cuda.synchronize()
        want_bwd = flash_mod.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
        bwd_errs = [(a.float() - b_).abs() for a, b_ in zip(grads, want_bwd)]
        bwd_err = max(float(e.max()) for e in bwd_errs)
        same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
        row = {"flash_attention_wgmma": list(shape), "max_abs_err": float(err.max()),
               "lse_max_abs_err": lse_err, "bwd_max_abs_err": bwd_err, "bwd_bit_identical": same}
        if not (float(err.max()) <= 2e-2 and lse_err <= 1e-3 and bwd_err <= 2e-2 and same):
            ok = False
            bad = (err > 2e-2).nonzero()
            row.update(bad_share=float((err > 2e-2).float().mean()), first_bad=bad[:12].tolist(),
                       bwd_err_by_output=[float(e.max()) for e in bwd_errs],
                       bwd_first_bad=[(e > 2e-2).nonzero()[:8].tolist() for e in bwd_errs])
        if timed:
            fma = flash_mod._forward_library()
            bh, s, d = shape[0] * shape[1], shape[2], shape[3]
            o2 = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            row.update(ms=device_ms(torch, lambda: flash_mod._launch_forward(q, k, v, False, scale)),
                       fma_ms=device_ms(torch, lambda: fma.flash_attention_fwd(
                           q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), None, bh, s, d, 1,
                           d ** -0.5, stream)),
                       library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)))
            bwd_fma = flash_mod._backward_library()
            delta = torch.empty(bh, s, device="cuda")
            g2 = [torch.empty_like(q) for _ in range(3)]
            leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
            out_lib = F.scaled_dot_product_attention(*leaves)
            row.update(bwd_ms=device_ms(torch, lambda: flash_mod._launch_backward(
                           q, k, v, out, lse, g, scale)),
                       bwd_fma_ms=device_ms(torch, lambda: bwd_fma.flash_attention_bwd(
                           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in g2), bh, s, d,
                           1, d ** -0.5, stream)),
                       bwd_library_ms=device_ms(torch, lambda: torch.autograd.grad(
                           out_lib, leaves, g, retain_graph=True)))
        emit(**row)
        if not ok:
            return 1

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in WGRAD_SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        g = (torch.randn(b, h, w, cout, device="cuda", generator=gen) * (cin / cout) ** 0.5).bfloat16()
        assert conv_mod.wgrad_kernel(x.dtype, cin, cout) == "wgmma"
        got = conv_mod._launch_wgrad(x, g)
        same = torch.equal(got, conv_mod._launch_wgrad(x, g))
        torch.cuda.synchronize()
        _, want = conv_mod.conv3x3_bwd_plain(x.float(), torch.zeros(9 * cin, cout, device="cuda"),
                                             g.float())
        err = (got - want).abs()
        bar = 1e-5 * (b * h * w) ** 0.5 + 1e-4 * want.abs()
        shape_k = (b, h, w, -(-cin // 8) * 8, -(-cout // 8) * 8)  # as the kernel sees it
        wg = conv_mod.wgrad_warpgroups(shape_k[4])
        row = {"conv3x3_wgrad_wgmma": list(shape), "warpgroups": wg,
               "n_slab": conv_mod.wgrad_wgmma_slabs(shape_k, wg, n_sm),
               "max_abs_err": float(err.max()), "err_over_bar": float((err / bar).max()),
               "bit_identical": same}
        if not (bool((err <= bar).all()) and same):
            ok = False
            bad = (err > bar).nonzero()
            row.update(bad_share=float((err > bar).float().mean()), first_bad=bad[:12].tolist(),
                       got=[float(got[tuple(i)]) for i in bad[:6]],
                       want=[float(want[tuple(i)]) for i in bad[:6]])
        lib = conv_mod._wgrad_wgmma_library()
        stream = torch.cuda.current_stream().cuda_stream

        def run(wg, n_slab):
            partials = torch.empty(n_slab, 9 * cin, cout, device="cuda")
            err = lib.conv3x3_wgrad_wgmma(x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w,
                                          cin, cout, n_slab, wg, stream)
            if err:
                raise RuntimeError(f"conv3x3_wgrad_wgmma {shape} {wg} {n_slab}: CUDA error {err}")
            return partials.sum(0)

        if timed:
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = torch.zeros(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            y_lib = F.conv2d(x_lib, w_lib, padding=1)
            fma = conv_mod._wgrad_library()
            n_fma = conv_mod.wgrad_slabs(tuple(x.shape), cout, n_sm)
            p_fma = torch.empty(n_fma, 9 * cin, cout, device="cuda")
            row.update(ms=device_ms(torch, lambda: conv_mod._launch_wgrad(x, g)),
                       fma_ms=device_ms(torch, lambda: fma.conv3x3_wgrad(
                           x.data_ptr(), g.data_ptr(), p_fma.data_ptr(), b, h, w, cin, cout, n_fma, 1,
                           stream)),
                       library_ms=device_ms(torch, lambda: torch.autograd.grad(
                           y_lib, w_lib, g.permute(0, 3, 1, 2), retain_graph=True)))
        if "--tiles" in sys.argv[1:] and shape == shape_k:  # warpgroups and slab counts
            _, want64 = conv_mod.conv3x3_bwd_plain(
                x.double(), torch.zeros(9 * cin, cout, device="cuda", dtype=torch.float64), g.double())
            by_tile = {}
            n_tiles = b * -(-h // 8) * -(-w // 16)
            for wg in (1, 2):
                picked = conv_mod.wgrad_wgmma_slabs(shape, wg, n_sm)
                for n_slab in sorted({max(1, picked // 2), picked, min(n_tiles, 2 * picked)}):
                    ms = device_ms(torch, lambda: run(wg, n_slab))
                    diff = run(wg, n_slab).double() - want64
                    by_tile[f"wg{wg} s{n_slab}"] = [
                        round(ms, 5), round(float(((run(wg, n_slab) - want).abs() / bar).max()), 3),
                        float(diff.mean() / want64.abs().mean()),
                        float(diff.pow(2).mean().sqrt() / want64.abs().mean())]
            row.update(ms_err_over_bar_bias_rms_by_warpgroups_and_slabs=by_tile)
        emit(**row)
        if not ok:
            return 1
    emit(ok=True, device=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
