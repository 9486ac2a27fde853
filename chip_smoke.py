#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, main path, timings.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device report (``nvidia-smi`` name and power limit, torch / CUDA versions);
2. build: the CUDA C++ kernels of ``pti_ldm_vae_tpu_torch/csrc`` with nvcc,
   the Triton kernels at their first launch;
3. kernel checks: every hand-written kernel against its plain PyTorch version
   on the card, f32 (atol 1e-5, rtol 1e-4) and bf16 (against the plain f32
   version on the same bf16-rounded inputs, atol 2e-2), at the shapes the
   main path gives it (GroupNorm+SiLU: the 8 shapes of a flagship
   reconstruct at 256², batch 8; flash attention: [8,1,1024,128] and a
   ragged [2,2,1000,64]);
4. main path: ``pti_ldm_vae_tpu_torch.cli.inference_vae`` on 16 synthetic
   300x300 TIFs at the flagship config ``config/vae_dente_no_adv.json``
   (256², batch 8) with random weights from a seeded ``torch.Generator``,
   once in bf16 (the default) and once with ``--f32``; each kernel's launch
   count is set to 0 just before a run and read just after (42
   GroupNorm+SiLU and 2 flash-attention launches per batch); outputs must be
   16 TIFs and 16 PNGs of finite values, and the f32 reconstructions of two
   images must match the CPU plain-version reconstruction to 1e-3;
5. timing after warm-up, L2 flushed before each call: device time
   (torch.profiler, the sum of the call's kernels) and CUDA-event time (which
   also holds waits for the host) of each kernel, its plain version and the
   one PyTorch library call that computes the same function, at every path
   shape; reconstruct imgs/s at b8 (event time), its device idle share and
   its device time by kind of kernel;
6. the ``kernels`` line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "vae_dente_no_adv.json"
WORK = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)
BATCH = 8
N_IMAGES = 16
# GroupNorm+SiLU launches per flagship reconstruct (21 encoder + 21 decoder)
# and flash-attention launches (encoder and decoder mid blocks)
GN_PER_RECONSTRUCT = 42
FLASH_PER_RECONSTRUCT = 2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, separators=(",", ":")), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_times_us(prof) -> dict[str, float]:
    """Device time (us) by kernel name in a profile, the L2 flush's fill kernel left out."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "FillFunctor" not in evt.name:
            out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return out


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> dict[str, float]:
    """Per call of ``fn()``, each after an L2 flush (a 128 MB write):
    ``device_ms``, the summed device time of its kernels (torch.profiler), and
    ``event_ms``, CUDA-event time from before its first launch to after its
    last, which also holds any wait for the host to launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    device = sum(_kernel_times_us(prof).values()) / 1e3 / iters
    return {"device_ms": device, "event_ms": total / iters}


def check_close(name: str, got, want, tol: dict) -> float:
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def gn_path_shapes(model, torch) -> list[tuple[tuple[int, ...], int]]:
    """[(NHWC shape at batch 8, launches per reconstruct)] of every
    GroupNorm+SiLU of a reconstruct, recorded with forward hooks during one
    CPU reconstruct of a single 256² image (plain versions, no launch)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import GroupNormOp

    counts: dict[tuple[int, ...], int] = {}

    def hook(module, args):
        if module.silu:
            shape = (BATCH, *args[0].shape[1:])
            counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, GroupNormOp)]
    try:
        with torch.inference_mode():
            model.reconstruct_deterministic(torch.zeros(1, 256, 256, 1))
    finally:
        for h in handles:
            h.remove()
    return sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3])


def reconstruct_breakdown(torch, reconstruct, x, iters: int = 5) -> dict[str, float]:
    """Device ms per reconstruct by kind of kernel (torch.profiler, warm L2)."""
    from torch.profiler import ProfilerActivity, profile

    reconstruct(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            reconstruct(x)
        torch.cuda.synchronize()
    kinds = (("groupnorm_silu", ("_stats_kernel", "_apply_kernel")),
             ("flash_attention", ("flash_fwd_kernel",)),
             # cuDNN's implicit-GEMM, FFT and layout kernels of the convolutions
             ("conv", ("conv", "fprop", "implicit", "cudnn", "nhwc", "nchw", "fft",
                       "pointwise_mult_and_sum_complex")),
             ("gemm", ("gemm", "cutlass", "nvjet")),  # the attention block's projections
             ("elementwise", ("elementwise_kernel",)))
    out: dict[str, float] = {}
    other: dict[str, float] = {}
    for name, us in _kernel_times_us(prof).items():
        kind = next((k for k, keys in kinds if any(w in name.lower() for w in keys)), "other")
        out[kind] = out.get(kind, 0.0) + us / 1e3 / iters
        if kind == "other":
            other[name[:90]] = us / 1e3 / iters
    out["top_other"] = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return out


def bound(flops: float, dtype: str, nbytes: float) -> tuple[float, str]:
    """Least time in ms: the larger of the operations over the card's peak for
    their type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernels(torch, gn_shapes, kernels_mod) -> dict[str, dict]:
    from pti_ldm_vae_tpu_torch.ops.kernels import flash_attention_plain, groupnorm_silu_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"groupnorm_silu": {"float32": 0.0, "bfloat16": 0.0},
            "flash_attention": {"float32": 0.0, "bfloat16": 0.0}}
    for shape, _ in gn_shapes:
        c = shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen)
        scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xd = x.to(dtype)
            got = kernels_mod.groupnorm_silu(xd, scale, bias, 16, 1e-6)
            want = groupnorm_silu_plain(xd.float(), scale, bias, 16, 1e-6)
            key = str(dtype).split(".")[1]
            err = check_close(f"groupnorm_silu {shape} {key}", got, want, tol)
            errs["groupnorm_silu"][key] = max(errs["groupnorm_silu"][key], err)
    for shape in ((BATCH, 1, 1024, 128), (2, 2, 1000, 64)):
        q, k, v = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            got = kernels_mod.flash_attention(qd, kd, vd)
            want = flash_attention_plain(qd.float(), kd.float(), vd.float())
            key = str(dtype).split(".")[1]
            err = check_close(f"flash_attention {shape} {key}", got, want, tol)
            errs["flash_attention"][key] = max(errs["flash_attention"][key], err)
    emit("kernel_checks", ok=True, max_abs_err=errs,
         tolerance={"float32": F32_TOL, "bfloat16": BF16_TOL})
    return errs


def make_weights(torch, ae_def: dict, path: Path) -> None:
    """Random flagship weights from a seeded generator, saved as a MONAI-keyed
    .pth: LeCun-normal conv/dense weights, small random biases and norm
    affines (so every parameter matters to the output)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    gen = torch.Generator().manual_seed(1234)
    sd = autoencoder_from_config(ae_def).state_dict()
    for key, p in sd.items():
        noise = torch.randn(p.shape, generator=gen)
        if p.dim() > 1:  # conv and dense weights
            sd[key] = noise * p[0].numel() ** -0.5
        elif key.endswith("weight"):  # GroupNorm scales, the only 1-D weights
            sd[key] = 1.0 + 0.1 * noise
        else:
            sd[key] = 0.1 * noise
    torch.save(sd, path)


def write_inputs(np, data_dir: Path) -> None:
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    data_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:300, 0:300]
    for i in range(N_IMAGES):
        img = (np.sin(xx / (9.0 + i)) * np.cos(yy / (13.0 + i)) + 1.5
               + 0.2 * rng.normal(size=(300, 300))).astype(np.float32)
        img[: 20 + i] = 0.0  # background, as the mask-aware normalization expects
        write_tif(str(data_dir / f"dente_{i:03d}.tif"), img)


def run_cli(torch, np, kernels_mod, args: list[str], out: Path) -> dict:
    from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_main
    from pti_ldm_vae_tpu_torch.data.io import read_image

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n = inference_main(args + ["--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"groupnorm_silu": kernels_mod.groupnorm_silu.launches,
                "flash_attention": kernels_mod.flash_attention.launches}
    batches = -(-N_IMAGES // BATCH)
    want = {"groupnorm_silu": GN_PER_RECONSTRUCT * batches,
            "flash_attention": FLASH_PER_RECONSTRUCT * batches}
    if n != N_IMAGES or launches != want:
        raise RuntimeError(f"main path: {n} images, launches {launches}, expected {want}")
    tifs = sorted((out / "results_tif").glob("*.tif"))
    pngs = sorted((out / "results_png").glob("*.png"))
    if len(tifs) != N_IMAGES or len(pngs) != N_IMAGES:
        raise RuntimeError(f"expected {N_IMAGES} TIFs and PNGs, got {len(tifs)} and {len(pngs)}")
    recon = [read_image(str(p))[:, 256:] for p in tifs]
    for p, r in zip(tifs, recon):
        if r.shape != (256, 256) or not np.isfinite(r).all():
            raise RuntimeError(f"{p.name}: bad reconstruction {r.shape}")
    return {"wall_s": wall, "launches": launches, "recon": recon}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pti_ldm_vae_tpu_torch").is_dir() or not CONFIG.exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # 1. device report
    card = card_line()
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from pti_ldm_vae_tpu_torch.ops import kernels as kernels_mod
    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _triton_kernels

    t0 = time.perf_counter()
    lib = _build.build("flash_attention.cu")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    import triton

    _triton_kernels()
    emit("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name,
         triton=triton.__version__, ptxas=ptxas[-8:])

    # 3. kernel checks at the path's shapes
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    ae_def = load_config(CONFIG)["autoencoder_def"]
    gn_shapes = gn_path_shapes(autoencoder_from_config(ae_def), torch)
    if sum(n for _, n in gn_shapes) != GN_PER_RECONSTRUCT:
        raise RuntimeError(f"GroupNorm+SiLU shapes {gn_shapes} do not add up to {GN_PER_RECONSTRUCT}")
    errs = check_kernels(torch, gn_shapes, kernels_mod)

    # 4. main path through the CLI
    shutil.rmtree(WORK, ignore_errors=True)
    write_inputs(np, WORK / "data" / "dente")
    ckpt = WORK / "vae_flagship_random.pth"
    make_weights(torch, ae_def, ckpt)
    cli = ["-c", str(CONFIG), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
           "--batch-size", str(BATCH), "--num-workers", "4"]
    bf16 = run_cli(torch, np, kernels_mod, cli, WORK / "out_bf16")
    emit("main_path", dtype="bfloat16", **{k: v for k, v in bf16.items() if k != "recon"})
    f32 = run_cli(torch, np, kernels_mod, cli + ["--f32"], WORK / "out_f32")
    emit("main_path", dtype="float32", **{k: v for k, v in f32.items() if k != "recon"})

    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    config = load_vae_config(str(CONFIG))
    cpu_model = load_vae_model(config, str(ckpt), device="cpu", s2d_stem=False)
    inputs = np.stack([preprocess_image_np(read_image(str(p)), (256, 256))
                       for p in sorted((WORK / "data" / "dente").glob("*.tif"))[:2]])
    with torch.inference_mode():
        ref = cpu_model.reconstruct_deterministic(torch.from_numpy(inputs)).numpy()[..., 0]
    err_f32 = float(np.abs(np.stack(f32["recon"][:2]) - ref).max())
    err_bf16 = float(np.abs(np.stack(bf16["recon"][:2]) - ref).max())
    emit("reference", images=2, max_abs_err_f32=err_f32, max_abs_err_bf16=err_bf16, bar_f32=1e-3)
    if not err_f32 <= 1e-3:
        raise RuntimeError(f"f32 CUDA reconstruction differs from the CPU plain path by {err_f32}")

    # 5. timing
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels import flash_attention_plain, groupnorm_silu_plain
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {"groupnorm_silu": [], "flash_attention": []}

    def timed(prefix: str, fn) -> dict[str, float]:
        t = time_ms(fn, flush)
        return {f"{prefix}ms": t["device_ms"], f"{prefix}event_ms": t["event_ms"]}

    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[1]
        for shape, n in gn_shapes:
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            scale = torch.ones(c, device="cuda")
            bias = torch.zeros(c, device="cuda")
            x_nchw = x.permute(0, 3, 1, 2)
            # ~8 f32 operations per element: two for the sums, one multiply-add,
            # the SiLU's exp, add and divide
            bound_ms, bound_by = bound(8 * x.numel(), "float32", 2 * x.numel() * x.element_size())
            row = {
                "shape": list(shape), "dtype": key, "per_reconstruct": n,
                **timed("", lambda: kernels_mod.groupnorm_silu(x, scale, bias, 16, 1e-6)),
                **timed("plain_", lambda: groupnorm_silu_plain(x, scale, bias, 16, 1e-6)),
                **timed("library_", lambda: F.silu(F.group_norm(
                    x_nchw, 16, scale.to(dtype), bias.to(dtype), 1e-6))),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            rows["groupnorm_silu"].append(row)
            emit("time_groupnorm_silu", **row)
        shape = (BATCH, 1, 1024, 128)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
        bound_ms, bound_by = bound(4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3], key,
                                   4 * q.numel() * q.element_size())
        row = {
            "shape": list(shape), "dtype": key, "per_reconstruct": FLASH_PER_RECONSTRUCT,
            **timed("", lambda: kernels_mod.flash_attention(q, k, v)),
            **timed("plain_", lambda: flash_attention_plain(q, k, v)),
            **timed("library_", lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows["flash_attention"].append(row)
        emit("time_flash_attention", **row)

    from pti_ldm_vae_tpu_torch.train.steps import make_inference_fn

    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    for exact in (False, True):
        _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                         exact=exact)
        reconstruct = make_inference_fn(model)
        t = time_ms(lambda: reconstruct(x), flush, iters=10)
        emit("reconstruct_b8", dtype="float32" if exact else "bfloat16",
             imgs_per_s=BATCH * 1e3 / t["event_ms"], **t,
             device_idle_share=1.0 - t["device_ms"] / t["event_ms"],
             device_ms_by_kind=reconstruct_breakdown(torch, reconstruct, x))

    # 6. kernels line, card line, result line
    def totals(name: str) -> dict:
        bf = [r for r in rows[name] if r["dtype"] == "bfloat16"]
        return {k: sum(r[k] * r["per_reconstruct"] for r in bf)
                for k in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms")}

    gn, fa = totals("groupnorm_silu"), totals("flash_attention")
    kernels = [
        {"name": "groupnorm_silu", "route": "triton",
         "source": "pti_ldm_vae_tpu_torch/ops/kernels/groupnorm_silu.py",
         "replaces": "pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py:121",
         "launches": bf16["launches"]["groupnorm_silu"],
         "max_abs_err": errs["groupnorm_silu"]["bfloat16"],
         "max_abs_err_f32": errs["groupnorm_silu"]["float32"],
         **gn, "bound_by": rows["groupnorm_silu"][0]["bound_by"],
         "scope": "bf16, device ms summed over the 42 launches of one b8 reconstruct"},
        {"name": "flash_attention", "route": "cuda",
         "source": "pti_ldm_vae_tpu_torch/csrc/flash_attention.cu",
         "replaces": "pti_ldm_vae_tpu/ops/pallas/flash_attention.py:65",
         "launches": bf16["launches"]["flash_attention"],
         "max_abs_err": errs["flash_attention"]["bfloat16"],
         "max_abs_err_f32": errs["flash_attention"]["float32"],
         **fa, "bound_by": rows["flash_attention"][0]["bound_by"],
         "scope": "bf16, device ms summed over the 2 launches of one b8 reconstruct"},
    ]
    print(json.dumps({"kernels": kernels}, separators=(",", ":")), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
