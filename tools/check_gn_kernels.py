#!/usr/bin/env python3
"""Check (and time) the GroupNorm+SiLU cluster kernels on one CUDA card.

    python3 tools/check_gn_kernels.py            # build, ptxas, plans, values
    python3 tools/check_gn_kernels.py --time     # + the Triton kernels they replaced, in turns
    python3 tools/check_gn_kernels.py --ablate   # + other cuts: staging modes, cluster caps

Builds ``csrc/groupnorm_silu_fwd.cu`` and ``csrc/groupnorm_silu_bwd.cu``
(``ptxas`` registers, spills and shared memory of every instantiation), then
for every shape of a flagship pass at b8 (the eight NHWC shapes of
``chip_smoke.py:gn_path_shapes``, 16 groups), two ragged ones ((1,7,9,24) with
4 groups, (3,17,9,48) with 16), (3,256,256,32) and one b32 shape (32x256²x64), in f32
and bf16 (and a bf16 view that is not 16-byte aligned, which takes the
one-channel route): the plan ``gn_plan`` picks, how many of its clusters the
card holds at once, and the forward (y, mean, inverse std) and backward (dx,
dscale, dbias) against the plain versions on the same inputs, with the bars
of ``tests/test_torch_kernels_cuda.py`` (f32 atol 1e-5 / rtol 1e-4; bf16
atol 2e-2 against the plain f32 version on the same rounded inputs;
dscale/dbias atol 1e-5*sqrt(B*H*W)); two runs must give the same bits.

``--time`` (the 8 path shapes, both dtypes): device ms per call (the sum of
the call's kernels in ``torch.profiler``, L2 flushed before each call, as
``chip_smoke.py:time_ms``) of the old Triton kernels (``gn_triton_baseline.py``)
and the new ones in turns, old / new / new / old, beside the bound (bytes
over 3.35 TB/s: forward x read + y written, backward x, g read + dx
written), the achieved bytes/s and the library call (``F.group_norm`` +
``F.silu`` on channels-last NCHW views, and its backward).

``--ablate`` (the path shapes of 128² and less): other cuts from
``gn_plan``: clusters of 4, 8 and 16 blocks, slices of 16 or 32 bytes a pixel
row, and the staging modes ("x", "xg", none), with the clusters of each cut
the card holds at once.

Every row is one JSON line on stdout and in ``chiprun_out/gn_check.jsonl``.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

PATH_SHAPES = [(8, 256, 256, 32), (8, 256, 256, 64), (8, 128, 128, 128), (8, 128, 128, 64),
               (8, 128, 128, 32), (8, 64, 64, 128), (8, 64, 64, 64), (8, 32, 32, 128)]
EXTRA_SHAPES = [(1, 7, 9, 24), (3, 17, 9, 48), (3, 256, 256, 32)]
B32_SHAPE = (32, 256, 256, 64)
OUT = ROOT / "chiprun_out" / "gn_check.jsonl"


def emit(**row) -> None:
    line = json.dumps(row, separators=(",", ":"))
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def groups_of(c: int) -> int:
    return 16 if c % 16 == 0 else 4


def inputs(torch, shape, dtype, gen, aligned=True):
    c = shape[-1]
    n = 1
    for s in shape:
        n *= s
    x = torch.randn(n + (0 if aligned else 1), device="cuda", generator=gen).to(dtype)
    x = x[(0 if aligned else 1):].view(shape)  # one element in: 2 or 4 bytes off 16
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, scale, bias, g


def check(torch, gn, shape, dtype, gen, aligned=True) -> dict:
    """Values of one shape and dtype against the plain versions; raises past a bar."""
    b, h, w, c = shape
    groups = groups_of(c)
    x, scale, bias, g = inputs(torch, shape, dtype, gen, aligned)
    fwd_plan = gn.gn_plan(b, h, w, c, groups, dtype, False, gn._aligned(x))
    bwd_plan = gn.gn_plan(b, h, w, c, groups, dtype, True, gn._aligned(x, g))
    code = gn._DTYPE_CODES[dtype]
    row = {"shape": list(shape), "dtype": str(dtype).split(".")[1], "groups": groups,
           "aligned": aligned, "fwd_plan": fwd_plan._asdict(), "bwd_plan": bwd_plan._asdict(),
           "fwd_clusters_resident": gn.max_active_clusters(
               "groupnorm_silu_fwd.cu", code, fwd_plan.vec, fwd_plan.cluster_size,
               fwd_plan.threads, fwd_plan.smem_bytes),
           "bwd_clusters_resident": gn.max_active_clusters(
               "groupnorm_silu_bwd.cu", code, bwd_plan.vec, bwd_plan.cluster_size,
               bwd_plan.threads, bwd_plan.smem_bytes)}
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0.0, atol=2e-2)
    sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
    y, mean_g, inv_g = gn._launch_forward(x, scale, bias, groups, 1e-6, save_stats=True)
    y2 = gn._launch_forward(x, scale, bias, groups, 1e-6, save_stats=False)[0]
    want, want_mean, want_inv = gn._plain_forward(x.float(), scale, bias, groups, 1e-6)
    torch.cuda.synchronize()
    row.update(fwd_max_abs_err=float((y.float() - want).abs().max()),
               mean_max_abs_err=float((mean_g - want_mean).abs().max()),
               inv_max_rel_err=float(((inv_g - want_inv) / want_inv).abs().max()),
               fwd_bit_identical=bool(torch.equal(y, y2)))
    dx, dscale, dbias = gn._launch_backward(x, scale, bias, mean_g, inv_g, g, groups)
    again = gn._launch_backward(x, scale, bias, mean_g, inv_g, g, groups)
    want_dx, want_dscale, want_dbias = gn.groupnorm_silu_bwd_plain(
        x.float(), scale, bias, want_mean, want_inv, g.float(), groups)
    torch.cuda.synchronize()
    row.update(dx_max_abs_err=float((dx.float() - want_dx).abs().max()),
               dscale_max_abs_err=float((dscale - want_dscale).abs().max()),
               dbias_max_abs_err=float((dbias - want_dbias).abs().max()),
               bwd_bit_identical=all(torch.equal(p, q) for p, q in zip((dx, dscale, dbias), again)))
    emit(**row)
    torch.testing.assert_close(y.float(), want, **tol)
    torch.testing.assert_close(mean_g, want_mean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(inv_g, want_inv, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dx.float(), want_dx, **tol)
    torch.testing.assert_close(dscale, want_dscale, **sum_tol)
    torch.testing.assert_close(dbias, want_dbias, **sum_tol)
    if not (row["fwd_bit_identical"] and row["bwd_bit_identical"]):
        raise RuntimeError(f"{shape} {dtype}: two runs differ")
    return row


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("check_gn_kernels: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import HBM_BYTES_PER_S, card_line, ptxas_report, time_ms
    from pti_ldm_vae_tpu_torch.ops.kernels import _build

    # the package re-exports the wrapper under the module's name
    gn = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("")
    args = sys.argv[1:]
    emit(card=card_line(), torch=torch.__version__, cuda=torch.version.cuda)
    libs = _build.build_all(gn.SOURCES)
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        emit(library=lib.name, ptxas=ptxas_report(lib.with_suffix(".log")),
             lines=[ln.split(":", 1)[-1].strip()[:140] for ln in log.splitlines()
                    if "entry function" in ln or "spill" in ln or "Used" in ln][:24])

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in PATH_SHAPES + EXTRA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check(torch, gn, shape, dtype, gen)
        torch.cuda.empty_cache()
    for shape in ((2, 64, 64, 32), (1, 7, 9, 24)):  # a view off 16 bytes: one channel per access
        for dtype in (torch.float32, torch.bfloat16):
            check(torch, gn, shape, dtype, gen, aligned=False)
    check(torch, gn, B32_SHAPE, torch.bfloat16, gen)
    torch.cuda.empty_cache()

    if "--time" not in args and "--ablate" not in args:
        emit(ok=True)
        return 0
    import gn_triton_baseline as old

    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)

    def ms(fn) -> float:
        return time_ms(fn, flush)["device_ms"]

    for dtype in (torch.bfloat16, torch.float32):
        for shape in PATH_SHAPES:
            b, h, w, c = shape
            x, scale, bias, g = inputs(torch, shape, dtype, gen)
            nbytes = x.numel() * x.element_size()
            _, mean_g, inv_g = gn._launch_forward(x, scale, bias, 16, 1e-6, save_stats=True)
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "fwd_bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
                   "bwd_bound_ms": 1e3 * 3 * nbytes / HBM_BYTES_PER_S}
            if "--time" in args:
                new_fwd = lambda: gn._launch_forward(x, scale, bias, 16, 1e-6, save_stats=True)  # noqa: E731
                old_fwd = lambda: old.launch_forward(x, scale, bias, 16, 1e-6, save_stats=True)  # noqa: E731
                new_bwd = lambda: gn._launch_backward(x, scale, bias, mean_g, inv_g, g, 16)  # noqa: E731
                old_bwd = lambda: old.launch_backward(x, scale, bias, mean_g, inv_g, g, 16)  # noqa: E731
                turns = {"fwd": [ms(old_fwd), ms(new_fwd), ms(new_fwd), ms(old_fwd)],
                         "bwd": [ms(old_bwd), ms(new_bwd), ms(new_bwd), ms(old_bwd)]}
                x_nchw = x.permute(0, 3, 1, 2)
                leaves = (x_nchw.detach().requires_grad_(), scale.to(dtype).requires_grad_(),
                          bias.to(dtype).requires_grad_())
                y_lib = F.silu(F.group_norm(leaves[0], 16, leaves[1], leaves[2], 1e-6))
                g_nchw = g.permute(0, 3, 1, 2)
                for kind in ("fwd", "bwd"):
                    t = turns[kind]
                    new_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                    row.update({f"{kind}_turns_old_new_new_old": t, f"{kind}_ms": new_ms,
                                f"{kind}_triton_ms": old_ms,
                                f"{kind}_tb_per_s": (2 if kind == "fwd" else 3) * nbytes / new_ms / 1e9})
                row.update(fwd_library_ms=ms(lambda: F.silu(F.group_norm(
                               x_nchw, 16, scale.to(dtype), bias.to(dtype), 1e-6))),
                           bwd_library_ms=ms(lambda: torch.autograd.grad(
                               y_lib, leaves, g_nchw, retain_graph=True)))
                del y_lib, leaves
            if "--ablate" in args and h * w <= 128 * 128:
                code = gn._DTYPE_CODES[dtype]
                # the cut gn_plan picks beside others: staging modes, cluster
                # sizes, 16-byte row segments (twice the clusters) where it picks 32
                variants = [(st, cs, seg) for st in ("x", "xg", "") for cs in (4, 8, 16)
                            for seg in (16, 32)]
                for kind, source in (("fwd", "groupnorm_silu_fwd.cu"), ("bwd", "groupnorm_silu_bwd.cu")):
                    for staged, cs, seg in variants:
                        if kind == "fwd" and staged == "xg":
                            continue
                        plan = gn.gn_plan(b, h, w, c, 16, dtype, kind == "bwd", staged=staged,
                                          cluster_size=cs, min_segment=seg)
                        if plan.cluster_size * plan.rows_per_block >= 2 * h * w:
                            continue  # a cluster larger than the image's rows need
                        resident = gn.max_active_clusters(source, code, plan.vec, plan.cluster_size,
                                                          plan.threads, plan.smem_bytes)
                        call = (lambda: gn._launch_forward(x, scale, bias, 16, 1e-6, True, plan=plan)
                                ) if kind == "fwd" else (lambda: gn._launch_backward(
                                    x, scale, bias, mean_g, inv_g, g, 16, plan=plan))
                        row[f"{kind}_{staged or 'none'}_cs{cs}_seg{seg}"] = {
                            "plan": list(plan), "resident": resident, "ms": ms(call)}
            emit(**row)
            del x, g, mean_g, inv_g
        torch.cuda.empty_cache()
    emit(ok=True, card=card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
