#!/usr/bin/env python3
"""Quick check of the seven tensor-core kernels on one CUDA card.

    python3 tools/check_wgmma_kernels.py [--time] [--tiles] [--wide | --conv]

Builds ``csrc/conv3x3_wgmma.cu``, ``csrc/conv3x3_stream_wgmma.cu``,
``csrc/flash_attention_wgmma.cu``, ``csrc/conv3x3_wgrad_wgmma.cu``,
``csrc/flash_attention_bwd_wgmma.cu`` and the wide-head flash kernels
``csrc/flash_attention_wide_wgmma.cu`` and
``csrc/flash_attention_bwd_wide_wgmma.cu`` (and the f32-FMA kernels beside
them; a few seconds), prints what ``ptxas`` reports for the seven, and holds
each against its plain PyTorch version at the
flagship path's shapes and at ragged ones: the forward kernels and the
attention backward in bf16 at atol 2e-2 on the same rounded inputs (flash
attention also at the rms of its error within 1e-2 of the reference's rms,
``FLASH_REL_BAR``, as ``chip_smoke.py`` holds it), the filter
gradient (f32 sums of exact products) at rtol 1e-4 / atol 1e-5 * sqrt(B*H*W);
both backward kernels also twice, for the same bits. With ``--time`` it also
prints device times per call (``torch.profiler``, L2 warm) beside the f32-FMA
kernels' and the library calls'. One JSON object per line; exits non-zero at
the first disagreement, after printing where the largest errors lie. With
``--tiles`` the convolution forward is also timed (and compared) at every
tile that fits, and the filter gradient with one and two warpgroups per
block at several slab counts, with the worst error over the bar and the mean signed
error against a float64 reference (the error that grows with the length of
an accumulation chain). The wide-head flash kernels run first (``--wide``:
only they, and the f32-FMA split kernels above head dim 512 beside them): in
bf16 against the plain version on the same rounded inputs, twice for the same
bits, with ``--time`` beside the f32-FMA kernels in bf16 (their route before
the wide kernels) and SDPA, and with ``--tiles`` the backward's signed and rms
error against a float64 reference beside the FMA kernels'; then the head dims
the wrapper pads in bf16, through ``flash_attention`` and autograd (the
padded call's scale is the caller's ``D^-0.5``). ``--conv``: only the
convolution forward kernels (after the build and ``ptxas``), at the flagship's
shapes, at every forward and input gradient of a
``config/ar_vae_dente_kl1e3.json`` pass (``Cin`` 256 with ``Cout`` >= 64 on
the streamed-weight kernel, ``csrc/conv3x3_stream_wgmma.cu``, the thin ``Cin``
1 and 10 padded with zero channels), at ``Cin`` 512 and at ``WGMMA_MAX_CIN``,
through the route the wrapper picks and, wherever ``Cout`` >= 64, through both
tensor-core kernels (the resident-slab one at its ``wgmma_tile``); with
``--time`` each beside the f32-FMA kernel on the same bf16 inputs in turns
(FMA, tensor cores, tensor cores, FMA), ``F.conv2d`` and the bound, and both
tensor-core kernels and ``F.conv2d`` with the L2 flushed before each call (in
turns: slab, stream, stream, slab; where the two kernels cross over), with
``--tiles`` the slab kernel at every ``(mt, tn, kc)`` that fits and is no
wider than the width that covers ``Cout``, and both kernels' mean signed and
rms error against a float64 convolution of image 0 beside one bf16
rounding's. ``chip_smoke.py`` is the full run.
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
               (8, 128, 128, 128, 128), (8, 256, 256, 64, 64),
               # the flagship's thin calls, padded with zero channels: the stem, the output
               # conv's input gradient, the latent's conv_in and conv_out's input gradient
               (8, 256, 256, 1, 32), (8, 32, 32, 4, 128), (1, 20, 12, 3, 5),
               # every distinct forward and input gradient of a kl1e3 pass at b8 (Cin, Cout)
               (8, 128, 128, 256, 256), (8, 128, 128, 256, 128), (8, 128, 128, 128, 256),
               (8, 256, 256, 128, 128), (8, 256, 256, 128, 64), (8, 256, 256, 64, 128),
               (8, 128, 128, 64, 128), (8, 128, 128, 128, 64), (8, 64, 64, 256, 256),
               (8, 64, 64, 128, 256), (8, 64, 64, 256, 128), (8, 64, 64, 256, 10),
               (8, 64, 64, 10, 256), (8, 256, 256, 1, 64), (8, 256, 256, 64, 1),
               # wider: 16 and 8 output columns a block
               (8, 32, 32, 512, 512), (2, 32, 32, 1520, 64),
               # the flagship's space-to-depth stem and output conv at 128²
               (8, 128, 128, 4, 128), (8, 128, 128, 128, 4)]
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
WGMMA_SOURCES = ("conv3x3_wgmma.cu", "conv3x3_stream_wgmma.cu", "flash_attention_wgmma.cu",
                 "conv3x3_wgrad_wgmma.cu", "flash_attention_bwd_wgmma.cu",
                 "flash_attention_wide_wgmma.cu", "flash_attention_bwd_wide_wgmma.cu")
# the wide-head flash kernels: every slice / residency mode (192 and 256 keep their A tiles
# whole, 320 and 512 stream them in the backward, 640 and 1024 also q in the forward), ragged
# lengths, and the two timed shapes (config/ar_vae_dente_kl1e3.json's mid blocks at b8, and a
# [128, 256, 512, 512] VAE's); D > 512 also in f32 (the FMA split kernels)
FLASH_WIDE_SHAPES = [(1, 1, 64, 192), (1, 2, 200, 256), (2, 1, 300, 320), (2, 1, 1024, 512),
                     (1, 1, 77, 640), (2, 1, 1024, 640), (1, 1, 512, 1024), (8, 1, 4096, 256),
                     (8, 1, 1024, 512)]
FLASH_TIMED = [(8, 1, 4096, 256), (8, 1, 1024, 512)]
FLASH_REL_BAR = 1e-2  # bf16 flash: rms of the error over rms of the plain f32 version
# head dims the wrapper pads in bf16 (96 -> 128 on the narrow kernels, 200 -> 256 and
# 1000 -> 1024 on the wide ones), through flash_attention and autograd at D^-0.5
FLASH_PADDED_SHAPES = [(8, 1, 1024, 96), (2, 1, 1024, 200), (1, 1, 512, 1000)]


def rel_rms(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def emit(**fields) -> None:
    print(json.dumps(fields, separators=(",", ":")), flush=True)


def device_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Device time per call of ``fn()``: the summed time of its kernels in a
    ``torch.profiler`` trace (no launch overhead). With ``flush`` (a tensor
    larger than the L2) the L2 is flushed before each call by zeroing it, and
    that fill kernel is left out of the sum; without, the L2 stays warm."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and (flush is None or "fill" not in e.name.lower()))
        if total_us > 0:
            return total_us / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device kernel in three traces")


def check_wide(torch, F, flash_mod, gen, timed: bool, tiles: bool) -> bool:
    """The wide-head flash kernels (and, above head dim 512, the f32-FMA split
    kernels) against their plain versions; one line per shape and type."""
    ok = True
    for shape in FLASH_WIDE_SHAPES:
        bh, s, d = shape[0] * shape[1], shape[2], shape[3]
        scale = d ** -0.5
        base = [torch.randn(shape, device="cuda", generator=gen) for _ in range(4)]
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and d <= 512:
                continue
            q, k, v, g = (t.to(dtype) for t in base)
            bar = 2e-2 if dtype == torch.bfloat16 else None
            route = flash_mod.forward_kernel(dtype, d)
            assert route == flash_mod.backward_kernel(dtype, d) == (
                "wgmma_wide" if dtype == torch.bfloat16 else "fma"), route
            out, lse = flash_mod._launch_forward(q, k, v, True, scale)
            out2, _ = flash_mod._launch_forward(q, k, v, True, scale)
            grads = flash_mod._launch_backward(q, k, v, out, lse, g, scale)
            again = flash_mod._launch_backward(q, k, v, out, lse, g, scale)
            torch.cuda.synchronize()
            want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float())
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            lse_err = float((lse - torch.logsumexp(scores, dim=-1)).abs().max())
            del scores
            want_bwd = flash_mod.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
            errs = [float((out.float() - want).abs().max())] + [
                float((a.float() - b_.float()).abs().max()) for a, b_ in zip(grads, want_bwd)]
            rels = [rel_rms(a, b_) for a, b_ in zip((out, *grads), (want, *want_bwd))]
            same = torch.equal(out, out2) and all(torch.equal(a, b_) for a, b_ in zip(grads, again))
            if bar is None:  # f32: rtol 1e-4 / atol 1e-5
                close = all(bool(((a.float() - b_).abs() <= 1e-5 + 1e-4 * b_.abs()).all())
                            for a, b_ in zip((out, *grads), (want, *want_bwd)))
            else:
                close = max(errs) <= bar and max(rels) <= FLASH_REL_BAR
            row = {"flash_wide": list(shape), "dtype": str(dtype).split(".")[1], "route": route,
                   "max_abs_err_out_dq_dk_dv": errs, "rel_rms_err_out_dq_dk_dv": rels,
                   "lse_max_abs_err": lse_err, "bit_identical": same, "close": close}
            if not (close and same and lse_err <= 1e-3):
                ok = False
            if timed and shape in FLASH_TIMED and dtype == torch.bfloat16:
                fma, bwd_fma = flash_mod._forward_library(), flash_mod._backward_library()
                stream = torch.cuda.current_stream().cuda_stream
                o2 = torch.empty_like(q)
                delta = torch.empty(bh, s, device="cuda")
                g2 = [torch.empty_like(q) for _ in range(3)]
                leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
                out_lib = F.scaled_dot_product_attention(*leaves)

                def fma_fwd():
                    return fma.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                   o2.data_ptr(), None, bh, s, d, 1, scale, stream)

                def fma_bwd():
                    return bwd_fma.flash_attention_bwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in g2), bh, s, d, 1,
                        scale, stream)

                # in turns: FMA, wide, wide, FMA
                times = {"fma_ms": [device_ms(torch, fma_fwd, 5)],
                         "ms": [device_ms(torch, lambda: flash_mod._launch_forward(q, k, v, False, scale))]}
                times["ms"].append(device_ms(torch, lambda: flash_mod._launch_forward(q, k, v, False, scale)))
                times["fma_ms"].append(device_ms(torch, fma_fwd, 5))
                times["bwd_fma_ms"] = [device_ms(torch, fma_bwd, 3)]
                times["bwd_ms"] = [device_ms(torch, lambda: flash_mod._launch_backward(
                    q, k, v, out, lse, g, scale)) for _ in range(2)]
                times["bwd_fma_ms"].append(device_ms(torch, fma_bwd, 3))
                times["library_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
                times["bwd_library_ms"] = device_ms(torch, lambda: torch.autograd.grad(
                    out_lib, leaves, g, retain_graph=True))
                row.update(times)
                del out_lib, leaves
            if tiles and dtype == torch.bfloat16 and shape in FLASH_TIMED:
                # signed and rms error of dq, dk, dv against float64, relative to mean |x|,
                # the wide kernel beside the FMA kernel (bf16 inputs, f32 sums, both)
                want64 = flash_mod.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                                             g.double())
                delta = torch.empty(bh, s, device="cuda")
                g2 = [torch.empty_like(q) for _ in range(3)]
                err = flash_mod._backward_library().flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in g2), bh, s, d, 1,
                    scale, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                torch.cuda.synchronize()
                for name, got in (("wide", grads), ("fma", g2)):
                    row[f"bias_rms_{name}"] = [
                        [float((a.double() - w).mean() / w.abs().mean()),
                         float((a.double() - w).pow(2).mean().sqrt() / w.abs().mean())]
                        for a, w in zip(got, want64)]
                del want64
            emit(**row)
            del out, out2, lse, grads, again, want, want_bwd
        del base
        torch.cuda.empty_cache()
    for shape in FLASH_PADDED_SHAPES:
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(4))
        leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
        flash_mod.flash_attention.padded_launches = 0
        out = flash_mod.flash_attention(*leaves)
        grads = torch.autograd.grad(out, leaves, g)
        padded = flash_mod.flash_attention.padded_launches
        want = (flash_mod.flash_attention_plain(q.float(), k.float(), v.float()),
                *flash_mod.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float()))
        errs = [float((a.float() - b_).abs().max()) for a, b_ in zip((out, *grads), want)]
        rels = [rel_rms(a, b_) for a, b_ in zip((out, *grads), want)]
        close = max(errs) <= 2e-2 and max(rels) <= FLASH_REL_BAR and padded == 2
        emit(flash_padded=list(shape), padded_head_dim=flash_mod.padded_head_dim(shape[-1], q.dtype),
             padded_launches=padded, max_abs_err_out_dq_dk_dv=errs, rel_rms_err_out_dq_dk_dv=rels,
             close=close)
        ok = ok and close
        del leaves, out, grads, want
    return ok


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
    for lib in libs[len(WGMMA_SOURCES):]:  # the FMA split kernels: registers and spills
        split, name = [], None
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in ln:
                name = ln.split("'")[1] if "split" in ln else None
            elif name and ("spill" in ln or "registers" in ln):
                split.append(f"{name[:48]}: {ln.strip()}")
        emit(library=lib.name, split_ptxas=split)
    for lib in libs[:len(WGMMA_SOURCES)]:
        log = lib.with_suffix(".log").read_text().splitlines()
        keep = [ln for ln in log if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
        emit(library=lib.name, ptxas=[ln for ln in keep if "injected" not in ln][:80],
             injected_waits=sum("injected" in ln for ln in keep),
             injected_reasons=sorted({ln.split("'")[0][-160:] for ln in keep if "injected" in ln}))

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    if "--conv" not in sys.argv[1:]:
        ok = check_wide(torch, F, flash_mod, gen, timed, "--tiles" in sys.argv[1:])
        for d in (192, 256, 320, 512, 640, 1024):
            got = flash_mod.wide_smem_of_library(d)
            want = (flash_mod.wide_fwd_smem_bytes(d), flash_mod.wide_bwd_smem_bytes(d))
            emit(wide_smem_blocks=d, **got, formula=want)
            ok = ok and (got["forward"][0], got["backward"][0]) == want and max(want) <= 232448
    conv_only = "--conv" in sys.argv[1:]
    if not ok or "--wide" in sys.argv[1:]:
        emit(ok=ok, device=torch.cuda.get_device_name(0))
        return 0 if ok else 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(32 * 2**20, device="cuda")  # 128 MB: more than the 50 MB L2
    slab_lib, stream_lib = conv_mod._wgmma_library(), conv_mod._stream_library()
    for shape in CONV_SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        wmat = (torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5).bfloat16()
        route = conv_mod.forward_kernel(x.dtype, cin, cout)
        assert route in ("wgmma", "wgmma_stream")
        got = conv_mod._launch_forward(x, wmat).float()
        again = conv_mod._launch_forward(x, wmat).float()
        torch.cuda.synchronize()
        want = conv_mod.conv3x3_plain(x.float(), wmat.float())
        err = (got - want).abs()
        # the kernel's operands: a thin Cin padded with zero channels, columns to a multiple of 8
        x_k, cin_k = conv_mod.pad_channels(x), -(-cin // 8) * 8
        w_k = conv_mod.pad_columns(conv_mod.pad_weight_channels(wmat, cin))
        picked = (conv_mod.wgmma_tile(b, h, w, cin_k, cout, n_sm) if route == "wgmma"
                  else conv_mod.STREAM_TILE)
        stream = torch.cuda.current_stream().cuda_stream
        y_other = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)
        slab_tile = conv_mod.wgmma_tile(b, h, w, cin_k, cout, n_sm)

        def slab_call(mt, tn, kc):  # the resident-slab kernel, at any tile that fits
            return slab_lib.conv3x3_wgmma_fwd(x_k.data_ptr(), w_k.data_ptr(), y_other.data_ptr(), b, h,
                                              w, cin_k, cout, w_k.shape[1], mt, tn, kc, stream)

        def stream_call():  # the streamed-weight kernel, whichever route the rule picks
            return stream_lib.conv3x3_stream_wgmma_fwd(x_k.data_ptr(), w_k.data_ptr(),
                                                       y_other.data_ptr(), b, h, w, cin_k, cout,
                                                       w_k.shape[1], stream)

        row = {"conv3x3_wgmma": list(shape), "route": route, "cin_kernel": cin_k,
               "picked": list(picked),
               "smem_bytes": (conv_mod.wgmma_smem_bytes(cin_k, *picked) if route == "wgmma"
                              else conv_mod.stream_smem_bytes()),
               "max_abs_err": float(err.max()), "bit_identical": torch.equal(got, again)}
        if not (float(err.max()) <= 2e-2 and row["bit_identical"]):
            ok = False
            bad = (err > 2e-2).nonzero()
            row.update(bad_share=float((err > 2e-2).float().mean()), first_bad=bad[:12].tolist(),
                       got=[float(got[tuple(i)]) for i in bad[:6]],
                       want=[float(want[tuple(i)]) for i in bad[:6]])
        # the other tensor-core kernel on the same operands, where both take the shape: the
        # streamed-weight kernel wherever Cout >= 64, the slab kernel at its own tile
        if cout >= 64 and cin_k >= 16:
            slab_out = torch.empty_like(y_other)
            err_slab = slab_lib.conv3x3_wgmma_fwd(x_k.data_ptr(), w_k.data_ptr(), slab_out.data_ptr(),
                                                  b, h, w, cin_k, cout, w_k.shape[1], *slab_tile, stream)
            if err_slab or stream_call():
                raise RuntimeError(f"conv3x3 {shape}: a launch failed")
            torch.cuda.synchronize()
            for name, out in (("slab", slab_out), ("stream", y_other)):
                other_err = float((out.float() - want).abs().max())
                row[f"{name}_max_abs_err"] = other_err
                ok = ok and other_err <= 2e-2
            if "--tiles" in sys.argv[1:] and b * h * w <= 8 * 128 * 128:
                # float64 reference on image 0: the mean signed error and the rms error of each
                # accumulation order, over the reference's rms, beside one bf16 rounding's
                ref = torch.nn.functional.conv2d(
                    x[:1].double().permute(0, 3, 1, 2),
                    wmat.double().reshape(3, 3, cin, cout).permute(3, 2, 0, 1), padding=1
                ).permute(0, 2, 3, 1)
                scale = float(ref.pow(2).mean().sqrt())
                for name, out in (("slab", slab_out), ("stream", y_other),
                                  ("bf16_rounding", ref.bfloat16())):
                    diff = out[:1].double() - ref
                    row[f"{name}_signed_rms_f64"] = [float(diff.mean()) / scale,
                                                     float(diff.pow(2).mean().sqrt()) / scale]
        if timed:
            x_lib = x.permute(0, 3, 1, 2)
            w_lib = (wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last))
            fma = conv_mod._forward_library()
            y = torch.empty(b, h, w, cout, device="cuda", dtype=torch.bfloat16)

            def fma_call():
                return fma.conv3x3_fwd(x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin,
                                       cout, 1, stream)

            # in turns: FMA, tensor cores (the wrapper, padding included), tensor cores, FMA
            fma_ms = [device_ms(torch, fma_call)]
            ms = [device_ms(torch, lambda: conv_mod._launch_forward(x, wmat)) for _ in range(2)]
            fma_ms.append(device_ms(torch, fma_call))
            flops = 2 * 9 * cin * cout * b * h * w
            nbytes = 2 * (x.numel() + wmat.numel() + b * h * w * cout)
            row.update(ms=ms, fma_ms=fma_ms,
                       library_ms=device_ms(torch, lambda: F.conv2d(x_lib, w_lib, padding=1)),
                       tflops=flops / (min(ms) * 1e-3) / 1e12,
                       bound_ms=max(flops / 989e12, nbytes / 3.35e12) * 1e3)
            if cout >= 64 and cin_k >= 16:
                # both tensor-core kernels and cuDNN with the L2 flushed before each call (the
                # 128 MB write's own kernel left out), in turns: slab, stream, stream, slab
                slab_ms = [device_ms(torch, lambda: slab_call(*slab_tile), 10, flush)]
                stream_ms = [device_ms(torch, stream_call, 10, flush) for _ in range(2)]
                slab_ms.append(device_ms(torch, lambda: slab_call(*slab_tile), 10, flush))
                row.update(flushed_slab_ms=slab_ms, flushed_stream_ms=stream_ms,
                           flushed_library_ms=device_ms(
                               torch, lambda: F.conv2d(x_lib, w_lib, padding=1), 10, flush),
                           stream_over_slab=min(stream_ms) / min(slab_ms))
        if "--tiles" in sys.argv[1:]:  # every tile that fits, beside the one ``wgmma_tile`` picks
            cover = next((tn for tn in (8, 16, 32) if cout <= tn), 64)
            by_tile, other_bits = {}, []
            slab_bits = None
            for tn in (tn for tn in (64, 32, 16, 8) if tn <= cover):
                for kc in (16, 32, 64):
                    for mt in (4, 2, 1):
                        if kc > max(cin_k, 16) or conv_mod.wgmma_smem_bytes(cin_k, mt, tn, kc) > 232448:
                            continue
                        tag = f"mt{mt} tn{tn} kc{kc}"
                        by_tile[tag] = round(device_ms(torch, lambda: slab_call(mt, tn, kc)), 5)
                        torch.cuda.synchronize()
                        # every tile of the slab kernel sums a pixel's products in the same order
                        if slab_bits is None:
                            slab_bits = y_other.clone()
                        elif not torch.equal(y_other, slab_bits):
                            other_bits.append(tag)
                            ok = ok and float((y_other.float() - want).abs().max()) <= 2e-2
            fastest = min(by_tile, key=by_tile.get)
            row.update(ms_by_tile=by_tile, fastest=fastest, tiles_with_other_bits=other_bits,
                       picked_over_fastest=by_tile["mt{} tn{} kc{}".format(*slab_tile)] / by_tile[fastest])
        emit(**row)
        if not ok:
            return 1
    if conv_only:
        emit(ok=ok, device=torch.cuda.get_device_name(0))
        return 0

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
        rels = [rel_rms(a, b_) for a, b_ in zip((out, *grads), (want, *want_bwd))]
        row = {"flash_attention_wgmma": list(shape), "max_abs_err": float(err.max()),
               "lse_max_abs_err": lse_err, "bwd_max_abs_err": bwd_err, "bwd_bit_identical": same,
               "rel_rms_err_out_dq_dk_dv": rels}
        if not (float(err.max()) <= 2e-2 and lse_err <= 1e-3 and bwd_err <= 2e-2 and same
                and max(rels) <= FLASH_REL_BAR):
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
