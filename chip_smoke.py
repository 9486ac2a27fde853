#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, main paths, timings.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device report (``nvidia-smi`` name and power limit, torch / CUDA versions);
2. build: the CUDA C++ kernels of ``pti_ldm_vae_tpu_torch/csrc`` with nvcc
   (one process per source, started together; ``ptxas`` registers and spills
   reported; for the two tensor-core sources also the shared memory per block
   and the resident blocks per SM of every instantiation, and whether their
   SASS holds ``HGMMA`` (``wgmma``) and ``LDGSTS`` (``cp.async``), read with
   ``cuobjdump`` where the toolkit has it), the Triton kernels at their first
   launch;
3. kernel checks at the shapes the main paths give them (GroupNorm+SiLU: the
   8 shapes of a flagship pass at 256², batch 8; flash attention:
   [8,1,1024,128], a ragged [2,2,1000,64] and [2,1,S,D] for D in 16, 32, 64,
   128 and S in 1024, 200, the backward from the logsumexp the forward wrote;
   the 3x3 convolution: the 14 distinct shapes of the 47 convolutions of a
   flagship pass, as forward, input gradient and filter gradient, a ragged
   [1,20,12,3->5] (which must go to the f32-FMA kernel) and a ragged
   [2,37,70,24->40] (which must go to the tensor-core kernel); its filter
   gradient ``dW`` is held like ``dscale``; bf16 inputs take the tensor-core
   kernels wherever the wrappers' rules send them there, f32 inputs the FMA
   kernels), every hand-written kernel
   against its plain PyTorch version on the card:
   forward kernels f32 (atol 1e-5, rtol 1e-4) and bf16 (against the plain f32
   version on the same bf16-rounded inputs, atol 2e-2); backward kernels the
   same bars for ``dx``, ``dq``, ``dk``, ``dv``; ``dscale`` / ``dbias`` are
   f32 sums over B*H*W terms of size ~1 (up to 524 288 here), held to rtol
   1e-4 with atol 1e-5 * sqrt(B*H*W) (the rounding of a sum grows with the
   root of its length); every backward, and the flash and convolution
   forward, runs twice and must give the same bits (no float atomics);
4. inference main path: ``pti_ldm_vae_tpu_torch.cli.inference_vae`` on 16
   synthetic 300x300 TIFs at the flagship config
   ``config/vae_dente_no_adv.json`` (256², batch 8) with random weights from a
   seeded ``torch.Generator``, in bf16 (the default) and with ``--f32``; launch
   counts are set to 0 just before a run and read just after (42
   GroupNorm+SiLU and 2 flash-attention launches per batch); outputs must be
   16 TIFs and 16 PNGs of finite values, and the f32 reconstructions of two
   images must match the CPU plain-version reconstruction to 1e-3;
5. training main path: ``pti_ldm_vae_tpu_torch.cli.train_vae`` on 72 synthetic
   TIFs at the same config (256², batch 8: 8 train steps and 1 validation
   step per epoch, 2 epochs), in bf16 and with ``--f32``; launch counts per
   train step 42 / 42 / 42 / 2 / 2 (GroupNorm+SiLU forward, backward reduce,
   backward dx, flash forward, flash backward), per eval step and per train
   triplet panel 42 / 0 / 0 / 2 / 0; finite losses, every parameter tensor
   moved from its seeded init, best/last checkpoints written, the best one
   reloaded through the inference CLI;
6. training reference: one f32 generator step on the card (launch counts of
   exactly one step asserted) against the same step on the CPU plain path
   from the same weights, batch (2 images at 256², full width) and ``eps``:
   loss terms within 1e-4 relative, every gradient tensor within 2e-3 of its
   largest entry;
6a. adversarial training main path: ``cli.train_vae --conv-kernel`` on
   ``config/vae_dente_2.json`` (same architecture, PatchGAN + LSGAN at
   ``adv_weight`` 3.0) with ``adv_warmup_epochs: 0`` for 3 epochs of 8 steps,
   so that epoch 0 runs the warm-up step and epochs 1-2 the adversarial one;
   all seven launch counts as computed from the step counts (per adversarial
   or warm-up train step 47 + 46 convolution-kernel launches, forward and
   input gradient, and 47 filter-gradient launches), ``train/adv_disc_loss``
   0 in epoch 0 and > 0 afterwards, finite losses, the discriminator and both
   optimizers in the checkpoints, and a resumed run that continues;
6b. adversarial training reference: one f32 adversarial step (generator
   pass, then the discriminator pass on the detached reconstruction) with
   ``conv_kernel=True`` on the card against the CPU plain path, batch 2 at
   256², full width: loss terms incl. both adversarial ones within 1e-4
   relative; of its largest entry, every gradient tensor of the generator
   without the adversarial term (the convolution kernels' dgrad and wgrad)
   and of the discriminator on one shared reconstruction within 2e-3, and
   every gradient tensor that passes through the discriminator from the two
   sides' own reconstructions within 2e-2 (LeakyReLU kinks: see
   ``adv_train_reference_check``);
7. timing after warm-up, L2 flushed before each call: device time
   (torch.profiler, the sum of the call's kernels) and CUDA-event time (which
   also holds waits for the host) of each kernel, its plain version and the
   one PyTorch library call that computes the same function, at every path
   shape; reconstruct and train-step imgs/s at b8 (event time), device idle
   share and device time by kind of kernel, also with ``conv_kernel=True``
   (and the train step with the adversarial branch active). The convolution
   kernels' library call is ``F.conv2d`` on channels-last tensors with TF32
   off, and its backward for one operand. To stay inside the time limit the
   per-kernel timings take 10 iterations and the reconstruct 6;
8. the ``kernels`` line (seven kernels), the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import copy
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "vae_dente_no_adv.json"
ADV_CONFIG = ROOT / "config" / "vae_dente_2.json"
WORK = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)
BATCH = 8
N_IMAGES = 16
# GroupNorm+SiLU launches per flagship pass (21 encoder + 21 decoder) and
# flash-attention launches (encoder and decoder mid blocks)
GN_PER_RECONSTRUCT = 42
FLASH_PER_RECONSTRUCT = 2
# training run: 72 images, 0.9 split -> 64 train (8 steps of 8) + 8 val (1 step)
TRAIN_IMAGES = 72
TRAIN_EPOCHS = 2
TRAIN_STEPS_PER_EPOCH = 8
EVAL_STEPS_PER_EPOCH = 1
TRAIN_SEED = 42
GRAD_BAR = 2e-3  # of each gradient tensor's largest entry, card f32 vs CPU f32
ADV_GRAD_BAR = 2e-2  # the same through the discriminator's LeakyReLU kinks (adv_train_reference_check)

# 3x3 stride-1 convolutions per flagship pass (22 encoder + 25 decoder); in a
# train step each also runs its filter gradient, and all but the encoder's
# stem (whose input needs no gradient) the forward kernel once more as dgrad
CONV_PER_RECONSTRUCT = 47
CONV_DGRAD_PER_STEP = 46
ADV_EPOCHS = 3
ADV_RESUME_EPOCHS = 4
RAGGED_CONV = (1, 20, 12, 3, 5)  # Cin 3: the f32-FMA kernel in either type
RAGGED_CONV_WGMMA = (2, 37, 70, 24, 40)  # Cin 24: the tensor-core kernel in bf16
FLASH_CHECK_SHAPES = ((BATCH, 1, 1024, 128), (2, 2, 1000, 64),
                      *((2, 1, s, d) for d in (16, 32, 64, 128) for s in (1024, 200)))
WGMMA_SOURCES = ("conv3x3_wgmma.cu", "flash_attention_wgmma.cu")

KERNEL_NAMES = ("groupnorm_silu", "groupnorm_silu_bwd_reduce", "groupnorm_silu_bwd_dx",
                "flash_attention", "flash_attention_bwd", "conv3x3", "conv3x3_wgrad")


def expected_launches(train_steps: int, forward_only: int, conv_kernel: bool) -> dict[str, int]:
    """Launch counts of a run of ``train_steps`` train steps and
    ``forward_only`` forward passes (eval steps, triplet panels, reconstructs)."""
    passes = train_steps + forward_only
    conv = CONV_PER_RECONSTRUCT * passes + CONV_DGRAD_PER_STEP * train_steps if conv_kernel else 0
    return {
        "groupnorm_silu": GN_PER_RECONSTRUCT * passes,
        "groupnorm_silu_bwd_reduce": GN_PER_RECONSTRUCT * train_steps,
        "groupnorm_silu_bwd_dx": GN_PER_RECONSTRUCT * train_steps,
        "flash_attention": FLASH_PER_RECONSTRUCT * passes,
        "flash_attention_bwd": FLASH_PER_RECONSTRUCT * train_steps,
        "conv3x3": conv,
        "conv3x3_wgrad": CONV_PER_RECONSTRUCT * train_steps if conv_kernel else 0,
    }


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, separators=(",", ":")), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def dtype_key(dtype) -> str:
    return str(dtype).split(".")[1]


def _kernel_times_us(prof) -> dict[str, float]:
    """Device time (us) by kernel name in a profile, the L2 flush's fill kernel left out."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "FillFunctor" not in evt.name:
            out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return out


def time_ms(fn, flush, iters: int = 10, warmup: int = 3) -> dict:
    """Per call of ``fn()``, each after an L2 flush (a 128 MB write):
    ``device_ms``, the summed device time of its kernels (torch.profiler),
    ``event_ms``, CUDA-event time from before its first launch to after its
    last, which also holds any wait for the host to launch, and ``by_name``,
    the device ms of each kernel name."""
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
    for _ in range(3):  # a trace now and then comes back without its device events: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        by_name = {name: us / 1e3 / iters for name, us in _kernel_times_us(prof).items()}
        if by_name:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device kernel in three traces")
    return {"device_ms": sum(by_name.values()), "event_ms": total / iters, "by_name": by_name}


def named_ms(by_name: dict[str, float], *words: str) -> float:
    return sum(ms for name, ms in by_name.items() if any(w in name for w in words))


def check_close(name: str, got, want, tol: dict) -> float:
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def gn_path_shapes(model, torch) -> list[tuple[tuple[int, ...], int]]:
    """[(NHWC shape at batch 8, launches per pass)] of every GroupNorm+SiLU of
    a flagship pass, recorded with forward hooks during one CPU reconstruct of
    a single 256² image (plain versions, no launch)."""
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


def conv_path_shapes(model, torch) -> list[tuple[tuple[int, ...], int]]:
    """[((B, H, W, Cin, Cout) at batch 8, launches per pass)] of every 3x3
    convolution a ``conv_kernel=True`` flagship pass sends to the convolution
    kernel, recorded like ``gn_path_shapes``."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import Convolution

    counts: dict[tuple[int, ...], int] = {}

    def hook(module, args):
        if module.conv_kernel:
            shape = (BATCH, *args[0].shape[1:], module.conv.out_channels)
            counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, Convolution)]
    try:
        with torch.inference_mode():
            model.reconstruct_deterministic(torch.zeros(1, 256, 256, 1))
    finally:
        for h in handles:
            h.remove()
    return sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3] * kv[0][4])


# kinds of device kernels, first match wins (lower-cased kernel names)
KINDS = (
    ("conv3x3_wgrad", ("conv3x3_wgrad_kernel",)),
    ("conv3x3", ("conv3x3_kernel", "conv3x3_wgmma_kernel")),
    ("groupnorm_silu_fwd", ("_stats_kernel", "_apply_kernel")),
    ("groupnorm_silu_bwd", ("_bwd_reduce_kernel", "_bwd_dx_kernel")),
    ("flash_attention_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("pool", ("max_pool",)),  # LPIPS trunk
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad",)),
    # cuDNN's implicit-GEMM, FFT and layout kernels of the convolutions
    ("conv_fwd", ("conv", "fprop", "implicit", "cudnn", "nhwc", "nchw", "fft",
                  "pointwise_mult_and_sum_complex")),
    ("gemm", ("gemm", "cutlass", "nvjet")),  # the attention block's projections
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel", "catarray", "fill")),
)


def device_ms_by_kind(by_name: dict[str, float]) -> dict:
    out: dict = {}
    other: dict[str, float] = {}
    for name, ms in by_name.items():
        kind = next((k for k, keys in KINDS if any(w in name.lower() for w in keys)), "other")
        out[kind] = out.get(kind, 0.0) + ms
        if kind == "other":
            other[name[:90]] = ms
    out["top_other"] = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return out


def bound(flops: float, dtype: str, nbytes: float) -> tuple[float, str]:
    """Least time in ms: the larger of the operations over the card's peak for
    their type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_report(log: Path) -> dict:
    """Registers and spills of every kernel in an nvcc ``-Xptxas -v`` log (per
    kernel: the entry-function line, the spill line, then the register line)."""
    kernels, name, spill = [], None, 0
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            kernels.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    def short(name: str) -> str:
        # kernel name and template arguments (element type, integers) out of the mangled name
        if m := re.search(r"\d((?:flash|conv3x3)\w*?_kernel)I(13__nv_bfloat16|f)?((?:Li\d+E)*)E", name):
            kind = {"13__nv_bfloat16": ["bf16"], "f": ["f32"], None: []}[m.group(2)]
            return f"{m.group(1)}<{','.join(kind + re.findall(r'Li(\d+)E', m.group(3)))}>"
        return re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f_]+", "", name)[:60]

    return {"kernels": len(kernels),
            "each": {short(k["kernel"]): [k["registers"], k["spill_bytes"]] for k in kernels},
            "max_registers": max((k["registers"] for k in kernels), default=0),
            "spill_bytes": sum(k["spill_bytes"] for k in kernels),
            # the instantiations the main paths run in bf16: head dim 128
            "d128_bf16": [{"kernel": short(k["kernel"]),
                           "registers": k["registers"], "spill_bytes": k["spill_bytes"]}
                          for k in kernels if "Li128E" in k["kernel"] and "bfloat16" in k["kernel"]]}


def wgmma_occupancy(torch, shapes) -> dict:
    """Shared memory per block (bytes) and resident blocks per SM, as the CUDA
    runtime reports them for this card, of the tensor-core convolution kernel
    at the tile each of ``shapes`` (forward and, with the channels swapped,
    input gradient) takes, with the tiles, the persistent blocks and the tiles
    per block that follow; and of every flash-attention instantiation."""
    import ctypes

    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import wgmma_smem_bytes, wgmma_tile

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    out: dict = {}
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    conv = _build.load("conv3x3_wgmma.cu")
    # the tiles the flagship pass's shapes take (Cin sizes the weight slab, kc the halo ring)
    for shape in shapes:
        b, h, w, cin, cout = shape
        if conv_forward_kernel(torch.bfloat16, cin) != "wgmma":
            continue
        mt, tn, kc = wgmma_tile(b, h, w, cin, cout, n_sm)
        err = conv.conv3x3_wgmma_occupancy(mt, tn, kc, cin, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0 or smem.value != wgmma_smem_bytes(cin, mt, tn, kc):
            raise RuntimeError(f"conv3x3_wgmma_occupancy({mt}, {tn}, {kc}, {cin}): CUDA error {err}, "
                               f"{smem.value} bytes against {wgmma_smem_bytes(cin, mt, tn, kc)}")
        tiles = b * -(-h // 8) * -(-w // (8 * mt))
        groups = -(-cout // tn)
        resident = min(tiles, -(-blocks.value * n_sm // groups)) * groups
        out[f"conv3x3_wgmma {list(shape)}"] = {
            "mt": mt, "tn": tn, "kc": kc, "smem_bytes": smem.value, "blocks_per_sm": blocks.value,
            "tiles": tiles * groups, "blocks": resident,
            "tiles_per_block": round(tiles * groups / resident, 2)}
    flash = _build.load("flash_attention_wgmma.cu")
    for d in (16, 32, 64, 128):
        err = flash.flash_attention_wgmma_occupancy(d, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"flash_attention_wgmma_occupancy({d}): CUDA error {err}")
        out[f"flash_attention_wgmma d{d}"] = {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}
    return out


def sass_report(libs: list[Path]) -> dict:
    """Whether each tensor-core library's SASS holds ``HGMMA`` (wgmma) and
    ``LDGSTS`` (cp.async) instructions, counted with ``cuobjdump -sass``; says
    so where the toolkit has no ``cuobjdump``."""
    import os

    tool = shutil.which("cuobjdump")
    if tool is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
        tool = str(candidate) if candidate.exists() else None
    if tool is None:
        return {"cuobjdump": None, "note": "no cuobjdump on this machine: SASS not read"}
    out: dict = {"cuobjdump": tool}
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts = {word: sass.count(word) for word in ("HGMMA", "LDGSTS", "UTMALDG")}
        if not counts["HGMMA"] or not counts["LDGSTS"]:
            raise RuntimeError(f"{lib.name}: SASS holds no HGMMA or no LDGSTS: {counts}")
        out[lib.name] = counts
    return out


def conv_inputs(torch, shape, gen):
    """f32 ``x``, weight matrix and upstream gradient of a convolution shape,
    scaled so that outputs and input gradients are of size ~1: the matrix by
    (9*Cin)^-0.5 as an initializer would, the gradient by (Cin/Cout)^0.5."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen)
    wmat = torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5
    g = torch.randn(b, h, w, cout, device="cuda", generator=gen) * (cin / cout) ** 0.5
    return x, wmat, g


def check_kernels(torch, gn_shapes, conv_shapes, kernels_mod) -> dict[str, dict]:
    from pti_ldm_vae_tpu_torch.ops.kernels import (
        conv3x3_bwd_plain,
        conv3x3_plain,
        flash_attention_bwd_plain,
        flash_attention_plain,
        groupnorm_silu_bwd_plain,
        groupnorm_silu_plain,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        forward_kernel as flash_forward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: {"float32": 0.0, "bfloat16": 0.0} for name in KERNEL_NAMES}

    def note(name, key, err):
        errs[name][key] = max(errs[name][key], err)

    for shape, _ in gn_shapes:
        c = shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen)
        scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (shape[0] * shape[1] * shape[2]) ** 0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            xd, gd = x.to(dtype), g.to(dtype)
            got = kernels_mod.groupnorm_silu(xd, scale, bias, 16, 1e-6)
            want, mean_g, inv_g = _plain_forward(xd.float(), scale, bias, 16, 1e-6)
            note("groupnorm_silu", key, check_close(f"groupnorm_silu {tag}", got, want, tol))
            del got, want

            leaves = (xd.clone().requires_grad_(), scale.clone().requires_grad_(),
                      bias.clone().requires_grad_())
            grads = [torch.autograd.grad(kernels_mod.groupnorm_silu(*leaves, 16, 1e-6), leaves, gd)
                     for _ in range(2)]
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"groupnorm_silu backward {tag}: two runs differ")
            dx, dscale, dbias = grads[0]
            want_dx, want_dscale, want_dbias = groupnorm_silu_bwd_plain(
                xd.float(), scale, bias, mean_g, inv_g, gd.float(), 16)
            note("groupnorm_silu_bwd_dx", key, check_close(f"groupnorm_silu dx {tag}", dx, want_dx, tol))
            note("groupnorm_silu_bwd_reduce", key, max(
                check_close(f"groupnorm_silu dscale {tag}", dscale, want_dscale, sum_tol),
                check_close(f"groupnorm_silu dbias {tag}", dbias, want_dbias, sum_tol)))
            del grads, dx, want_dx, leaves
    routes: dict[str, dict] = {"flash_attention": {}, "conv3x3": {}}
    for shape in FLASH_CHECK_SHAPES:
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen) for _ in range(4))
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            qd, kd, vd, gd = q.to(dtype), k.to(dtype), v.to(dtype), g.to(dtype)
            routes["flash_attention"][tag] = flash_forward_kernel(dtype, shape[-1])
            got = kernels_mod.flash_attention(qd, kd, vd)
            if not torch.equal(got, kernels_mod.flash_attention(qd, kd, vd)):
                raise RuntimeError(f"flash_attention forward {tag}: two runs differ")
            want = flash_attention_plain(qd.float(), kd.float(), vd.float())
            note("flash_attention", key, check_close(f"flash_attention {tag}", got, want, tol))

            leaves = tuple(t.clone().requires_grad_() for t in (qd, kd, vd))
            grads = [torch.autograd.grad(kernels_mod.flash_attention(*leaves), leaves, gd)
                     for _ in range(2)]
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"flash_attention backward {tag}: two runs differ")
            want = flash_attention_bwd_plain(qd.float(), kd.float(), vd.float(), gd.float())
            for name, ours, theirs in zip(("dq", "dk", "dv"), grads[0], want):
                note("flash_attention_bwd", key,
                     check_close(f"flash_attention {name} {tag}", ours, theirs, tol))
    for shape in [s for s, _ in conv_shapes] + [RAGGED_CONV, RAGGED_CONV_WGMMA]:
        x, wmat, g = conv_inputs(torch, shape, gen)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (shape[0] * shape[1] * shape[2]) ** 0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            xd, gd = x.to(dtype), g.to(dtype)
            wd = wmat.to(dtype).float()  # the matrix as the kernels see it
            # which kernel the forward and the input gradient (Cout in Cin's place) take
            routes["conv3x3"][tag] = [conv_forward_kernel(dtype, shape[3]),
                                      conv_forward_kernel(dtype, shape[4])]
            got = kernels_mod.conv3x3(xd, wmat)
            if not torch.equal(got, kernels_mod.conv3x3(xd, wmat)):
                raise RuntimeError(f"conv3x3 forward {tag}: two runs differ")
            want = conv3x3_plain(xd.float(), wd)
            err_fwd = check_close(f"conv3x3 {tag}", got, want, tol)
            del got, want

            leaves = (xd.clone().requires_grad_(), wmat.clone().requires_grad_())
            grads = [torch.autograd.grad(kernels_mod.conv3x3(*leaves), leaves, gd) for _ in range(2)]
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"conv3x3 backward {tag}: two runs differ")
            dx, dw = grads[0]
            want_dx, want_dw = conv3x3_bwd_plain(xd.float(), wd, gd.float())
            note("conv3x3", key, max(err_fwd, check_close(f"conv3x3 dgrad {tag}", dx, want_dx, tol)))
            note("conv3x3_wgrad", key, check_close(f"conv3x3 wgrad {tag}", dw, want_dw, sum_tol))
            del grads, dx, dw, want_dx, want_dw, leaves
        del x, wmat, g
    torch.cuda.empty_cache()
    by_rule = {f"{RAGGED_CONV} bfloat16": ["fma", "fma"],
               f"{RAGGED_CONV_WGMMA} bfloat16": ["wgmma", "wgmma"],
               f"{RAGGED_CONV_WGMMA} float32": ["fma", "fma"]}
    for tag, want_route in by_rule.items():
        if routes["conv3x3"][tag] != want_route:
            raise RuntimeError(f"conv3x3 {tag} went to {routes['conv3x3'][tag]}, expected {want_route}")
    if any(r != ("wgmma" if "bfloat16" in tag else "fma") for tag, r in routes["flash_attention"].items()):
        raise RuntimeError(f"flash_attention forward routes: {routes['flash_attention']}")
    emit("kernel_checks", ok=True, max_abs_err=errs, backward_bit_identical=True,
         forward_bit_identical=True, forward_kernel=routes,
         flash_shapes=[list(s) for s in FLASH_CHECK_SHAPES],
         conv_shapes=[[list(s), n] for s, n in conv_shapes]
         + [[list(RAGGED_CONV), 0], [list(RAGGED_CONV_WGMMA), 0]],
         tolerance={"float32": F32_TOL, "bfloat16": BF16_TOL,
                    "dscale_dbias_dW": "rtol 1e-4, atol 1e-5*sqrt(B*H*W)"})
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


def write_inputs(np, data_dir: Path, n: int) -> None:
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    data_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:300, 0:300]
    for i in range(n):
        img = (np.sin(xx / (9.0 + i)) * np.cos(yy / (13.0 + i)) + 1.5
               + 0.2 * rng.normal(size=(300, 300))).astype(np.float32)
        img[: 20 + i % 40] = 0.0  # background, as the mask-aware normalization expects
        write_tif(str(data_dir / f"dente_{i:03d}.tif"), img)


def run_cli(torch, np, kernels_mod, args: list[str], out: Path, n_images: int = N_IMAGES) -> dict:
    from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_main
    from pti_ldm_vae_tpu_torch.data.io import read_image

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n = inference_main(args + ["--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    want = expected_launches(0, -(-n_images // BATCH), "--conv-kernel" in args)
    if n != n_images or launches != want:
        raise RuntimeError(f"inference path: {n} images, launches {launches}, expected {want}")
    tifs = sorted((out / "results_tif").glob("*.tif"))
    pngs = sorted((out / "results_png").glob("*.png"))
    if len(tifs) != n_images or len(pngs) != n_images:
        raise RuntimeError(f"expected {n_images} TIFs and PNGs, got {len(tifs)} and {len(pngs)}")
    recon = [read_image(str(p))[:, 256:] for p in tifs]
    for p, r in zip(tifs, recon):
        if r.shape != (256, 256) or not np.isfinite(r).all():
            raise RuntimeError(f"{p.name}: bad reconstruction {r.shape}")
    return {"wall_s": wall, "launches": launches, "recon": recon}


def run_train_cli(torch, np, kernels_mod, ae_def: dict, data_dir: Path, run_dir: Path,
                  extra: list[str]) -> dict:
    """The training entry point for 2 epochs at the flagship config, with the
    launch counts, the losses, the parameters and the checkpoints checked."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    cfg = json.loads(CONFIG.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data_dir), str(run_dir)
    cfg_path = run_dir.parent / f"{run_dir.name}.json"
    cfg_path.write_text(json.dumps(cfg))

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", str(TRAIN_EPOCHS), "--no-wandb",
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    train_steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    # forward-only passes: the eval steps and one train triplet panel per epoch
    forward_only = TRAIN_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1)
    want = expected_launches(train_steps, forward_only, conv_kernel=False)
    if result["total_step"] != train_steps or launches != want:
        raise RuntimeError(f"training path: {result}, launches {launches}, expected {want}")

    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = [r for r in rows if "val/loss_total" in r]
    if len(train_rows) != train_steps or len(val_rows) != TRAIN_EPOCHS:
        raise RuntimeError(f"metrics.jsonl: {len(train_rows)} train rows, {len(val_rows)} val rows")
    for r in train_rows + val_rows:
        bad = [k for k, v in r.items() if k.startswith(("train/", "val/")) and not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite losses {bad} in {r}")
    split = json.loads((run_dir / "splits" / "vae_split.json").read_text())
    if len(split["train_files"]) != TRAIN_STEPS_PER_EPOCH * BATCH or len(split["val_files"]) != BATCH:
        raise RuntimeError("unexpected train/val split")

    weights = run_dir / "trained_weights"
    full = sorted(weights.glob("checkpoint_epoch*.pth"))
    best = sorted(weights.glob("autoencoder_epoch*.pth"))
    if len(full) != 1 or len(best) != 1 or not (weights / "autoencoder_last.pth").exists():
        raise RuntimeError(f"checkpoints: {sorted(p.name for p in weights.iterdir())}")
    last = torch.load(weights / "autoencoder_last.pth", map_location="cpu", weights_only=True)
    torch.manual_seed(TRAIN_SEED)  # the trainer's own seeding of the parameter init
    init = autoencoder_from_config(ae_def).state_dict()
    stuck = [k for k, v in last.items() if not torch.isfinite(v).all() or torch.equal(v, init[k])]
    if set(last) != set(init) or stuck:
        raise RuntimeError(f"parameters not finite or not moved from their init: {stuck[:5]}")
    run_config = json.loads((run_dir / "run_config.json").read_text())
    return {
        "wall_s": wall, "launches": launches, "total_step": result["total_step"],
        "best_val_loss": result["best_val_loss"],
        "first_train": {k: v for k, v in train_rows[0].items() if k.startswith("train/")},
        "last_train": {k: v for k, v in train_rows[-1].items() if k.startswith("train/")},
        "val": [{k: v for k, v in r.items() if k.startswith("val/")} for r in val_rows],
        "perceptual_pretrained": run_config["perceptual_pretrained"],
        "checkpoints": sorted(p.name for p in weights.iterdir()),
        "best_checkpoint": str(best[0]),
    }


def train_reference_check(torch, np, kernels_mod, ae_def: dict, data_dir: Path) -> None:
    """One f32 generator step (losses and gradients) on the card against the
    CPU plain path, same weights, batch and eps; also the launch counts of
    exactly one train step and one eval step."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses, make_eval_step

    torch.manual_seed(7)
    cpu_model = autoencoder_from_config(ae_def)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", memory_format=torch.channels_last)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0)
    images = torch.from_numpy(np.stack([
        preprocess_image_np(read_image(str(p)), (256, 256))
        for p in sorted(data_dir.glob("*.tif"))[:2]]))
    mask = torch.ones(2)
    eps = torch.randn(2, 32, 32, ae_def["latent_channels"], generator=torch.Generator().manual_seed(8))

    def one(model, device):
        lp = init_lpips_params(0, device)
        total, aux = _generator_losses(model, lcfg, lp, images.to(device), mask.to(device),
                                       eps.to(device), None)
        total.backward()
        terms = {k: float(aux[k].detach()) for k in ("recon_loss", "kl_loss", "perceptual_loss")}
        terms["loss_total"] = float(total.detach())
        return terms, {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    kernels_mod.reset_launch_counts()
    got_terms, got_grads = one(gpu_model, "cuda")
    torch.cuda.synchronize()
    per_train_step = kernels_mod.launch_counts()
    want = expected_launches(1, 0, conv_kernel=False)
    if per_train_step != want:
        raise RuntimeError(f"one train step launched {per_train_step}, expected {want}")
    kernels_mod.reset_launch_counts()
    make_eval_step(gpu_model, None, lcfg, adv_active=False)(
        None, images.cuda(), mask.cuda(), None, init_lpips_params(0, "cuda"), eps=eps.cuda())
    per_eval_step = kernels_mod.launch_counts()
    want_eval = expected_launches(0, 1, conv_kernel=False)
    if per_eval_step != want_eval:
        raise RuntimeError(f"one eval step launched {per_eval_step}, expected {want_eval}")

    want_terms, want_grads = one(cpu_model, "cpu")
    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    grad_err = {}
    for key, ref in want_grads.items():
        scale = float(ref.abs().max())
        err = float((got_grads[key] - ref).abs().max())
        # a key projection's bias has gradient 0 in exact arithmetic (softmax is
        # invariant to a constant along the keys): both sides hold rounding noise
        grad_err[key] = err if key.endswith("to_k.bias") else err / scale
    worst = max(grad_err, key=grad_err.get)
    emit("train_reference", batch=2, terms_card=got_terms, terms_cpu=want_terms,
         max_term_rel_err=max(term_err.values()), term_bar=1e-4,
         max_grad_err_of_tensor_max=grad_err[worst], worst_tensor=worst, grad_bar=GRAD_BAR,
         launches_per_train_step=per_train_step, launches_per_eval_step=per_eval_step)
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"f32 CUDA loss terms differ from the CPU plain path: {term_err}")
    if not grad_err[worst] <= GRAD_BAR:
        raise RuntimeError(f"f32 CUDA gradient {worst} differs from the CPU plain path by "
                           f"{grad_err[worst]} of its largest entry")


def run_adv_train_cli(torch, np, kernels_mod, data_dir: Path, run_dir: Path) -> dict:
    """The training entry point on the adversarial flagship config with the
    convolution kernels: 3 epochs with ``adv_warmup_epochs: 0``, so epoch 0
    runs the warm-up step and epochs 1-2 the adversarial one; then a resumed
    run to epoch 4. Launch counts, losses and checkpoints are checked."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main

    cfg = json.loads(ADV_CONFIG.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data_dir), str(run_dir)
    cfg["autoencoder_train"]["adv_warmup_epochs"] = 0
    cfg_path = run_dir.parent / f"{run_dir.name}.json"
    cfg_path.write_text(json.dumps(cfg))
    cli = ["--no-wandb", "--num-workers", "4", "--seed", str(TRAIN_SEED), "--conv-kernel"]

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", str(ADV_EPOCHS), *cli])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    train_steps = ADV_EPOCHS * TRAIN_STEPS_PER_EPOCH
    want = expected_launches(train_steps, ADV_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1), conv_kernel=True)
    if result["total_step"] != train_steps or launches != want or not all(launches.values()):
        raise RuntimeError(f"adversarial path: {result}, launches {launches}, expected {want}")

    def rows_of(kind: str) -> list[dict]:
        lines = (run_dir / "metrics.jsonl").read_text().splitlines()
        return [r for r in map(json.loads, lines) if f"{kind}/loss_total" in r]

    train_rows, val_rows = rows_of("train"), rows_of("val")
    if len(train_rows) != train_steps or len(val_rows) != ADV_EPOCHS:
        raise RuntimeError(f"metrics.jsonl: {len(train_rows)} train rows, {len(val_rows)} val rows")
    for r in train_rows + val_rows:
        bad = [k for k, v in r.items() if k.startswith(("train/", "val/")) and not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite losses {bad} in {r}")
    warm, active = train_rows[:TRAIN_STEPS_PER_EPOCH], train_rows[TRAIN_STEPS_PER_EPOCH:]
    if any(r["train/adv_disc_loss"] != 0.0 or r["train/adv_gen_loss"] != 0.0 for r in warm):
        raise RuntimeError("the adversarial terms are not 0 during the warm-up epoch")
    if not all(r["train/adv_disc_loss"] > 0.0 and r["train/adv_gen_loss"] > 0.0 for r in active):
        raise RuntimeError("the adversarial terms are not > 0 once the branch is active")
    if val_rows[0]["val/adv_disc_loss"] != 0.0 or not val_rows[-1]["val/adv_disc_loss"] > 0.0:
        raise RuntimeError(f"val/adv_disc_loss: {[r['val/adv_disc_loss'] for r in val_rows]}")

    weights = run_dir / "trained_weights"
    full = sorted(weights.glob("checkpoint_epoch*.pth"))
    names = sorted(p.name for p in weights.iterdir())
    if len(full) != 1 or not {"autoencoder_last.pth", "discriminator_last.pth"} <= set(names):
        raise RuntimeError(f"checkpoints: {names}")
    raw = torch.load(full[0], map_location="cpu", weights_only=True)
    need = {"autoencoder_state_dict", "discriminator_state_dict", "optimizer_g_state_dict",
            "optimizer_d_state_dict", "epoch", "best_val_loss", "total_step"}
    if not need <= set(raw) or f"discriminator_epoch{raw['epoch']}.pth" not in names:
        raise RuntimeError(f"full checkpoint holds {sorted(raw)}; files {names}")
    last_d = torch.load(weights / "discriminator_last.pth", map_location="cpu", weights_only=True)
    if not all(torch.isfinite(v).all() for v in last_d.values()):
        raise RuntimeError("discriminator_last.pth holds non-finite values")

    # resume: continues at the best epoch + 1 from both models and both optimizers
    cfg["resume_ckpt"] = True
    cfg_path.write_text(json.dumps(cfg))
    resumed = train_main(["-c", str(cfg_path), "--max-epochs", str(ADV_RESUME_EPOCHS), *cli])
    torch.cuda.synchronize()
    new_rows = rows_of("train")[train_steps:]
    first_step = TRAIN_STEPS_PER_EPOCH * (raw["epoch"] + 1) + 1
    if (resumed["total_step"] != ADV_RESUME_EPOCHS * TRAIN_STEPS_PER_EPOCH
            or not new_rows or new_rows[0]["train/step"] != first_step
            or not all(np.isfinite(r["train/loss_total"]) for r in new_rows)):
        raise RuntimeError(f"resume: {resumed}, first new step "
                           f"{new_rows[0]['train/step'] if new_rows else None}, expected {first_step}")
    adv_terms = ("train/adv_gen_loss", "train/adv_disc_loss", "train/loss_total")
    return {
        "wall_s": wall, "launches": launches, "total_step": result["total_step"],
        "best_val_loss": result["best_val_loss"],
        "first_warmup": {k: warm[0][k] for k in adv_terms},
        "first_adversarial": {k: active[0][k] for k in adv_terms},
        "last_adversarial": {k: active[-1][k] for k in adv_terms},
        "val_adv_disc_loss": [r["val/adv_disc_loss"] for r in val_rows],
        "checkpoints": names, "resumed_from_epoch": raw["epoch"],
        "resumed_total_step": resumed["total_step"],
    }


def adv_train_reference_check(torch, np, kernels_mod, ae_def: dict, data_dir: Path,
                              weights: Path) -> None:
    """One f32 adversarial step (generator pass, discriminator pass; losses
    and gradients of both models) with the convolution kernels on the card
    against the CPU plain path, same weights, batch and eps; also the launch
    counts of its one forward and two backward passes through the generator
    (the adversarial term's share is taken apart by a backward of its own).
    The generator starts from the seeded
    variance-preserving weights of ``make_weights`` (a default-initialized
    decoder draws nearly flat images, whose spatial variance after the
    discriminator's first layers falls below the instance norm's eps).

    Bars. Loss terms: 1e-4 relative. Gradients, each tensor against its
    largest entry: the generator's gradient of everything but the adversarial
    term, which runs through the convolution kernels' dgrad and wgrad, and
    the discriminator's gradients on one and the same reconstruction: 2e-3.
    Whatever passes through the discriminator from a reconstruction that
    differs in f32 rounding (2e-5 here) is held to 2e-2: a LeakyReLU unit
    whose pre-activation lies within that difference takes the other slope
    on one side, and a share p of such units moves a gradient by about
    sqrt(p) of its size (5e-3 to 8e-3 measured, with cuDNN convolutions in
    the generator as with the kernels)."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _discriminator_loss, _generator_losses

    cpu_model = autoencoder_from_config(ae_def, conv_kernel=True)
    cpu_model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True), strict=True)
    # the trainer's own init: instance norm keeps the logits of size ~1
    cpu_disc = PatchDiscriminator(generator=torch.Generator().manual_seed(10))
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", memory_format=torch.channels_last)
    gpu_disc = copy.deepcopy(cpu_disc).to(device="cuda", memory_format=torch.channels_last)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=3.0)
    images = torch.from_numpy(np.stack([
        preprocess_image_np(read_image(str(p)), (256, 256))
        for p in sorted(data_dir.glob("*.tif"))[:2]]))
    mask = torch.ones(2)
    eps = torch.randn(2, 32, 32, ae_def["latent_channels"], generator=torch.Generator().manual_seed(11))

    def disc_grads(disc, recon, x, m):
        d_loss = _discriminator_loss(disc, recon, x, m)
        grads = torch.autograd.grad(lcfg.adv_weight * d_loss, list(disc.parameters()))
        return d_loss.detach(), {k: g.cpu() for (k, _), g in zip(disc.named_parameters(), grads)}

    def one(model, disc, device, shared_recon):
        lp = init_lpips_params(0, device)
        x, m = images.to(device), mask.to(device)
        params = list(model.parameters())
        total, aux = _generator_losses(model, lcfg, lp, x, m, eps.to(device), None, disc)
        # the adversarial term's share apart, then the whole objective
        adv_part = torch.autograd.grad(aux["adv_gen_loss"], params, retain_graph=True)
        whole = torch.autograd.grad(total, params)
        d_loss, d_grads = disc_grads(disc, aux["recon"], x, m)
        terms = {k: float(aux[k].detach()) for k in
                 ("recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss")}
        terms.update(loss_total=float(total.detach()), adv_disc_loss=float(d_loss))
        names = [k for k, _ in model.named_parameters()]
        grads = {
            "generator": {k: g.cpu() for k, g in zip(names, whole)},
            "generator_without_adversary": {k: (g - lcfg.adv_weight * a).cpu()
                                            for k, g, a in zip(names, whole, adv_part)},
            "discriminator": d_grads,
            "discriminator_on_shared_reconstruction": disc_grads(
                disc, (aux["recon"].detach() if shared_recon is None else shared_recon).to(device),
                x, m)[1],
        }
        return terms, grads, aux["recon"].detach().cpu()

    want_terms, want_grads, cpu_recon = one(cpu_model, cpu_disc, "cpu", None)
    kernels_mod.reset_launch_counts()
    got_terms, got_grads, gpu_recon = one(gpu_model, gpu_disc, "cuda", cpu_recon)
    torch.cuda.synchronize()
    per_step = kernels_mod.launch_counts()
    # the second backward of the generator repeats the 46 + 47 backward launches of the
    # convolutions (and the backward launches of the other kernels)
    want = expected_launches(1, 0, conv_kernel=True)
    for name in ("groupnorm_silu_bwd_reduce", "groupnorm_silu_bwd_dx", "flash_attention_bwd",
                 "conv3x3_wgrad"):
        want[name] *= 2
    want["conv3x3"] += CONV_DGRAD_PER_STEP
    if per_step != want:
        raise RuntimeError(f"one adversarial step launched {per_step}, expected {want}")

    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    bars = {"generator": ADV_GRAD_BAR, "discriminator": ADV_GRAD_BAR,
            "generator_without_adversary": GRAD_BAR,
            "discriminator_on_shared_reconstruction": GRAD_BAR}
    worst = {}
    for group, refs in want_grads.items():
        errs = {}
        for key, ref in refs.items():
            err = float((got_grads[group][key] - ref).abs().max())
            # a key projection's bias has gradient 0 in exact arithmetic: rounding noise on both sides
            errs[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
        key = max(errs, key=errs.get)
        worst[group] = {"tensor": key, "err_of_tensor_max": errs[key], "bar": bars[group]}
    emit("adv_train_reference", batch=2, conv_kernel=True, terms_card=got_terms,
         terms_cpu=want_terms, max_term_rel_err=max(term_err.values()), term_bar=1e-4,
         reconstruction_max_abs_diff=float((gpu_recon - cpu_recon).abs().max()),
         worst_gradient=worst, launches=per_step)
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"f32 CUDA adversarial loss terms differ from the CPU plain path: {term_err}")
    for group, w in worst.items():
        if not w["err_of_tensor_max"] <= w["bar"]:
            raise RuntimeError(f"f32 CUDA {group} gradient {w['tensor']} differs from the CPU plain "
                               f"path by {w['err_of_tensor_max']} of its largest entry (bar {w['bar']})")


def time_train_step(torch, ae_def: dict, flush, exact: bool, conv_kernel: bool = False,
                    adv_active: bool = False) -> dict:
    """Event ms, device ms and the device ms by kind of one b8 train step at
    256²; the LPIPS share is the device ms a step without the perceptual term
    saves. ``conv_kernel``: the 3x3 convolutions through the convolution
    kernels; ``adv_active``: the adversarial step (PatchGAN, adv_weight 3.0)."""
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step
    from pti_ldm_vae_tpu_torch.utils.cli_common import enable_parity_numerics

    if exact:
        enable_parity_numerics()
    torch.manual_seed(3)
    torch.cuda.reset_peak_memory_stats()
    dtype = torch.float32 if exact else torch.bfloat16
    model = autoencoder_from_config(ae_def, compute_dtype=dtype, conv_kernel=conv_kernel).to(
        device="cuda", memory_format=torch.channels_last)
    disc = None
    if adv_active:
        disc = PatchDiscriminator(compute_dtype=dtype, generator=torch.Generator().manual_seed(5)).to(
            device="cuda", memory_format=torch.channels_last)
    state = create_train_state(model, lr=2.5e-5, model_d=disc)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    mask = torch.ones(BATCH, device="cuda")
    lp = init_lpips_params(0, "cuda")
    out = {}
    for name, lcfg in (("full", LossConfig(adv_weight=3.0)),
                       ("no_lpips", LossConfig(adv_weight=3.0, use_perceptual=False))):
        step = make_train_step(model, disc, lcfg, adv_active=adv_active)
        out[name] = time_ms(lambda: step(state, x, mask, None, lp, generator=gen), flush,
                            iters=6, warmup=3)
    full = out["full"]
    kinds = device_ms_by_kind(full["by_name"])
    kinds["lpips_by_difference"] = full["device_ms"] - out["no_lpips"]["device_ms"]
    return {"dtype": dtype_key(dtype), "conv_kernel": conv_kernel, "adv_active": adv_active,
            "event_ms": full["event_ms"], "device_ms": full["device_ms"],
            "imgs_per_s": BATCH * 1e3 / full["event_ms"],
            "device_idle_share": 1.0 - full["device_ms"] / full["event_ms"],
            "event_ms_no_lpips": out["no_lpips"]["event_ms"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms_by_kind": kinds}


def time_conv3x3(torch, conv_shapes, flush, gen, rows: dict[str, list]) -> None:
    """Per distinct convolution shape of the flagship pass and dtype: the
    forward kernel as forward and as input gradient, and the filter-gradient
    kernel, each beside its bound, its plain version and the library call
    (``F.conv2d`` on channels-last tensors with TF32 off; its backward for the
    one operand). ``kernel`` names the forward kernel the wrapper's rule picks
    for the call (``wgmma``: the tensor-core kernel, ``fma``: the f32-FMA one).
    The filter gradient's time includes the fold of its partial sums (one
    ``torch.sum``)."""
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
        _launch_forward,
        _launch_wgrad,
        conv3x3_bwd_plain,
        conv3x3_plain,
        flip_transpose,
        forward_kernel,
    )

    def timed(prefix: str, fn) -> dict[str, float]:
        t = time_ms(fn, flush)
        return {f"{prefix}ms": t["device_ms"], f"{prefix}event_ms": t["event_ms"]}

    for dtype in (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        for shape, n in conv_shapes:
            b, h, w, cin, cout = shape
            x, wmat, g = (t.to(dtype).contiguous() for t in conv_inputs(torch, shape, gen))
            wflip = flip_transpose(wmat, cin, cout).contiguous()
            flops = 2.0 * 9 * cin * cout * b * h * w
            size = x.element_size()
            # only the encoder's stem reads the 1-channel image, whose gradient
            # nobody wants: its dgrad is not on the path
            n_dgrad = 0 if cin == 1 else n
            head = {"shape": list(shape), "dtype": key}

            # the library call: NCHW views of the channels-last memory, OIHW channels-last weight
            x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_()
            w_lib = (wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last).requires_grad_())
            g_lib = g.permute(0, 3, 1, 2)
            y_lib = F.conv2d(x_lib, w_lib, padding=1)

            bound_ms, bound_by = bound(flops, key, (x.numel() + wmat.numel() + g.numel()) * size)
            row = {**head, "role": "forward", "per_pass": n, "kernel": forward_kernel(dtype, cin),
                   **timed("", lambda: _launch_forward(x, wmat)),
                   **timed("plain_", lambda: conv3x3_plain(x, wmat)),
                   **timed("library_", lambda: F.conv2d(x_lib.detach(), w_lib.detach(), padding=1)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3"].append(row)
            emit("time_conv3x3", **row)

            row = {**head, "role": "dgrad", "per_pass": n_dgrad, "kernel": forward_kernel(dtype, cout),
                   **timed("", lambda: _launch_forward(g, wflip)),
                   **timed("plain_", lambda: conv3x3_plain(g, wflip)),
                   **timed("library_", lambda: torch.autograd.grad(y_lib, x_lib, g_lib,
                                                                   retain_graph=True)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3"].append(row)
            emit("time_conv3x3", **row)

            bound_ms, bound_by = bound(flops, key,
                                       (x.numel() + g.numel()) * size + wmat.numel() * 4)
            ours = time_ms(lambda: _launch_wgrad(x, g), flush)
            row = {**head, "role": "wgrad", "per_pass": n,
                   "ms": ours["device_ms"], "event_ms": ours["event_ms"],
                   "kernel_only_ms": named_ms(ours["by_name"], "conv3x3_wgrad_kernel"),
                   # the plain backward computes dx too; its dW part is nine products
                   **timed("plain_", lambda: conv3x3_bwd_plain(x, wmat, g)[1]),
                   **timed("library_", lambda: torch.autograd.grad(y_lib, w_lib, g_lib,
                                                                   retain_graph=True)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3_wgrad"].append(row)
            emit("time_conv3x3_wgrad", **row)
            del x, wmat, g, wflip, x_lib, w_lib, g_lib, y_lib
        torch.cuda.empty_cache()


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
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import SOURCES as CONV_SOURCES
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import SOURCES as FLASH_SOURCES
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _triton_kernels

    t0 = time.perf_counter()
    libs = _build.build_all((*FLASH_SOURCES, *CONV_SOURCES))  # one nvcc each, started together
    import triton

    _triton_kernels()
    emit("build", seconds=round(time.perf_counter() - t0, 3), libraries=[p.name for p in libs],
         triton=triton.__version__,
         ptxas={p.name: ptxas_report(p.with_suffix(".log")) for p in libs})

    # 3. kernel checks at the paths' shapes
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    ae_def = load_config(CONFIG)["autoencoder_def"]
    probe = autoencoder_from_config(ae_def, conv_kernel=True)
    gn_shapes = gn_path_shapes(probe, torch)
    if sum(n for _, n in gn_shapes) != GN_PER_RECONSTRUCT:
        raise RuntimeError(f"GroupNorm+SiLU shapes {gn_shapes} do not add up to {GN_PER_RECONSTRUCT}")
    conv_shapes = conv_path_shapes(probe, torch)
    if sum(n for _, n in conv_shapes) != CONV_PER_RECONSTRUCT:
        raise RuntimeError(f"3x3 convolution shapes {conv_shapes} do not add up to "
                           f"{CONV_PER_RECONSTRUCT}")
    del probe
    both_ways = sorted({s for s, _ in conv_shapes} | {(*s[:3], s[4], s[3]) for s, _ in conv_shapes})
    emit("wgmma_kernels", occupancy=wgmma_occupancy(torch, both_ways),
         sass=sass_report([_build.library_path(src) for src in WGMMA_SOURCES]))
    errs = check_kernels(torch, gn_shapes, conv_shapes, kernels_mod)
    torch.cuda.empty_cache()

    # 4. inference main path through the CLI
    shutil.rmtree(WORK, ignore_errors=True)
    write_inputs(np, WORK / "data" / "dente", N_IMAGES)
    ckpt = WORK / "vae_flagship_random.pth"
    make_weights(torch, ae_def, ckpt)
    cli = ["-c", str(CONFIG), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
           "--batch-size", str(BATCH), "--num-workers", "4"]
    bf16 = run_cli(torch, np, kernels_mod, cli, WORK / "out_bf16")
    emit("main_path", dtype="bfloat16", **{k: v for k, v in bf16.items() if k != "recon"})
    f32 = run_cli(torch, np, kernels_mod, cli + ["--f32"], WORK / "out_f32")
    emit("main_path", dtype="float32", **{k: v for k, v in f32.items() if k != "recon"})

    conv_f32 = run_cli(torch, np, kernels_mod, cli + ["--f32", "--conv-kernel"],
                       WORK / "out_f32_conv_kernel")
    emit("main_path", dtype="float32", conv_kernel=True,
         **{k: v for k, v in conv_f32.items() if k != "recon"})

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
    err_conv = float(np.abs(np.stack(conv_f32["recon"][:2]) - ref).max())
    emit("reference", images=2, max_abs_err_f32=err_f32, max_abs_err_bf16=err_bf16,
         max_abs_err_f32_conv_kernel=err_conv, bar_f32=1e-3)
    if not max(err_f32, err_conv) <= 1e-3:
        raise RuntimeError(f"f32 CUDA reconstruction differs from the CPU plain path by {err_f32} "
                           f"(cuDNN convolutions), {err_conv} (convolution kernels)")

    # 5. training main path through the CLI
    train_data = WORK / "train_data"
    write_inputs(np, train_data / "dente", TRAIN_IMAGES)
    train = {}
    for key, extra in (("bfloat16", []), ("float32", ["--f32"])):
        train[key] = run_train_cli(torch, np, kernels_mod, ae_def, train_data,
                                   WORK / f"run_{key}", extra)
        emit("train_path", dtype=key, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, epochs=TRAIN_EPOCHS,
             **train[key])
    reloaded = run_cli(
        torch, np, kernels_mod,
        ["-c", str(CONFIG), "--checkpoint", train["bfloat16"]["best_checkpoint"], "--input-dir",
         str(WORK / "data"), "--batch-size", str(BATCH), "--num-workers", "4", "--num-samples", "8"],
        WORK / "out_trained", n_images=8)
    emit("train_reload", checkpoint=Path(train["bfloat16"]["best_checkpoint"]).name,
         images=8, launches=reloaded["launches"])

    # 6. one f32 train step on the card against the CPU plain path
    train_reference_check(torch, np, kernels_mod, ae_def, train_data / "dente")
    torch.cuda.empty_cache()

    # 6a. adversarial training main path through the CLI, convolution kernels on
    adv = run_adv_train_cli(torch, np, kernels_mod, train_data, WORK / "run_adv")
    emit("adv_train_path", dtype="bfloat16", conv_kernel=True, steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
         epochs=ADV_EPOCHS, adv_warmup_epochs=0, **adv)
    # 6b. one f32 adversarial step on the card against the CPU plain path
    adv_train_reference_check(torch, np, kernels_mod, ae_def, train_data / "dente", ckpt)
    torch.cuda.empty_cache()

    # 7. timing
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels import (
        flash_attention_bwd_plain,
        flash_attention_plain,
        groupnorm_silu_bwd_plain,
        groupnorm_silu_plain,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import _launch_backward as flash_backward
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import _launch_forward as flash_forward
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        forward_kernel as flash_forward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _launch_backward as gn_backward
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _launch_forward as gn_forward
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows: dict[str, list] = {name: [] for name in KERNEL_NAMES}

    def timed(prefix: str, fn) -> dict[str, float]:
        t = time_ms(fn, flush)
        return {f"{prefix}ms": t["device_ms"], f"{prefix}event_ms": t["event_ms"]}

    for dtype in (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        for shape, n in gn_shapes:
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            scale = torch.ones(c, device="cuda")
            bias = torch.zeros(c, device="cuda")
            nbytes = x.numel() * x.element_size()
            head = {"shape": list(shape), "dtype": key, "per_pass": n}
            # forward: ~8 f32 operations per element (two for the sums, one
            # multiply-add, the SiLU's exp, add and divide)
            x_nchw = x.permute(0, 3, 1, 2)
            bound_ms, bound_by = bound(8 * x.numel(), "float32", 2 * nbytes)
            row = {
                **head,
                **timed("", lambda: kernels_mod.groupnorm_silu(x, scale, bias, 16, 1e-6)),
                **timed("plain_", lambda: groupnorm_silu_plain(x, scale, bias, 16, 1e-6)),
                **timed("library_", lambda: F.silu(F.group_norm(
                    x_nchw, 16, scale.to(dtype), bias.to(dtype), 1e-6))),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            rows["groupnorm_silu"].append(row)
            emit("time_groupnorm_silu", **row)

            # backward: one call launches the reduce and the dx kernel (plus one
            # small torch.sum); the plain version and the library call do the
            # work of both kernels at once
            _, mean_g, inv_g = gn_forward(x, scale, bias, 16, 1e-6, save_stats=True)
            ours = time_ms(lambda: gn_backward(x, scale, bias, mean_g, inv_g, g, 16), flush)
            plain = timed("plain_", lambda: groupnorm_silu_bwd_plain(
                x, scale, bias, mean_g, inv_g, g, 16))
            leaves = (x_nchw.detach().requires_grad_(), scale.to(dtype).requires_grad_(),
                      bias.to(dtype).requires_grad_())
            y_lib = F.silu(F.group_norm(leaves[0], 16, leaves[1], leaves[2], 1e-6))
            g_nchw = g.permute(0, 3, 1, 2)
            library = timed("library_", lambda: torch.autograd.grad(
                y_lib, leaves, g_nchw, retain_graph=True))
            del y_lib, leaves
            # ~20 f32 operations per element in either kernel (xhat, n, the
            # sigmoid's exp and divide, dn, the products and sums)
            for name, word, passes in (("groupnorm_silu_bwd_reduce", "_bwd_reduce_kernel", 2),
                                       ("groupnorm_silu_bwd_dx", "_bwd_dx_kernel", 3)):
                bound_ms, bound_by = bound(20 * x.numel(), "float32", passes * nbytes)
                row = {**head, "ms": named_ms(ours["by_name"], word),
                       "call_device_ms": ours["device_ms"], "event_ms": ours["event_ms"],
                       **plain, **library, "bound_ms": bound_ms, "bound_by": bound_by}
                rows[name].append(row)
                emit(f"time_{name}", **row)

        shape = (BATCH, 1, 1024, 128)
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
        nbytes = q.numel() * q.element_size()
        head = {"shape": list(shape), "dtype": key, "per_pass": FLASH_PER_RECONSTRUCT}
        products = 2 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]  # one [S,S]x[S,D] product
        bound_ms, bound_by = bound(2 * products, key, 4 * nbytes)
        row = {
            **head, "kernel": flash_forward_kernel(dtype, shape[-1]),
            **timed("", lambda: kernels_mod.flash_attention(q, k, v)),
            **timed("plain_", lambda: flash_attention_plain(q, k, v)),
            **timed("library_", lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows["flash_attention"].append(row)
        emit("time_flash_attention", **row)

        out, lse = flash_forward(q, k, v, save_lse=True)
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        out_lib = F.scaled_dot_product_attention(*leaves)
        # five products; reads q, k, v, out, dO, writes dq, dk, dv
        bound_ms, bound_by = bound(5 * products, key, 8 * nbytes)
        ours = time_ms(lambda: flash_backward(q, k, v, out, lse, g), flush)
        row = {
            **head, "ms": ours["device_ms"], "event_ms": ours["event_ms"],
            "ms_by_kernel": {w: named_ms(ours["by_name"], w) for w in
                             ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")},
            **timed("plain_", lambda: flash_attention_bwd_plain(q, k, v, g)),
            **timed("library_", lambda: torch.autograd.grad(out_lib, leaves, g, retain_graph=True)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del out_lib, leaves
        rows["flash_attention_bwd"].append(row)
        emit("time_flash_attention_bwd", **row)

    time_conv3x3(torch, conv_shapes, flush, gen, rows)

    from pti_ldm_vae_tpu_torch.train.steps import make_inference_fn

    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    for exact, conv_kernel in ((False, False), (True, False), (False, True), (True, True)):
        _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                         exact=exact, conv_kernel=conv_kernel)
        reconstruct = make_inference_fn(model)
        t = time_ms(lambda: reconstruct(x), flush, iters=6)
        emit("reconstruct_b8", dtype="float32" if exact else "bfloat16", conv_kernel=conv_kernel,
             imgs_per_s=BATCH * 1e3 / t["event_ms"], device_ms=t["device_ms"],
             event_ms=t["event_ms"], device_idle_share=1.0 - t["device_ms"] / t["event_ms"],
             device_ms_by_kind=device_ms_by_kind(t["by_name"]))
        del model, reconstruct
    torch.cuda.empty_cache()
    # the generator-only step on cuDNN convolutions (both types), the adversarial
    # step on cuDNN convolutions, the adversarial step on the convolution kernels
    for exact, conv_kernel, adv_active in ((False, False, False), (True, False, False),
                                           (False, False, True), (False, True, True),
                                           (True, True, True)):
        emit("train_step_b8", **time_train_step(torch, ae_def, flush, exact, conv_kernel, adv_active))
        torch.cuda.empty_cache()

    # 8. kernels line, card line, result line
    def totals(name: str) -> dict:
        bf = [r for r in rows[name] if r["dtype"] == "bfloat16"]
        return {k: sum(r[k] * r["per_pass"] for r in bf)
                for k in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms")}

    gn_source = "pti_ldm_vae_tpu_torch/ops/kernels/groupnorm_silu.py"
    gn_pallas = "pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py"
    fa_pallas = "pti_ldm_vae_tpu/ops/pallas/flash_attention.py"
    both = ("; plain_ms and library_ms are the whole backward (reduce and dx together), "
            "event_ms the whole backward call")
    described = {
        "groupnorm_silu": ("triton", gn_source, f"{gn_pallas}:121",
                           "bf16, device ms summed over the 42 launches of one b8 pass"),
        "groupnorm_silu_bwd_reduce": ("triton", gn_source, f"{gn_pallas}:221",
                                      "bf16, device ms summed over the 42 launches of one b8 "
                                      "train step" + both),
        "groupnorm_silu_bwd_dx": ("triton", gn_source, f"{gn_pallas}:248",
                                  "bf16, device ms summed over the 42 launches of one b8 "
                                  "train step" + both),
        "flash_attention": ("cuda", "pti_ldm_vae_tpu_torch/csrc/flash_attention_wgmma.cu",
                            f"{fa_pallas}:65",
                            "bf16 (the tensor-core kernel; f32 inputs: source_f32), device ms "
                            "summed over the 2 launches of one b8 pass"),
        "flash_attention_bwd": ("cuda", "pti_ldm_vae_tpu_torch/csrc/flash_attention_bwd.cu",
                                f"{fa_pallas}:122",
                                "bf16, device ms summed over the 2 launches of one b8 train step "
                                "(each launch: delta, dk/dv and dq kernels)"),
        "conv3x3": ("cuda", "pti_ldm_vae_tpu_torch/csrc/conv3x3_wgmma.cu",
                    "pti_ldm_vae_tpu/ops/pallas/conv2d.py:120",
                    "bf16 (the tensor-core kernel where Cin is a multiple of 8, else the "
                    "kernel of source_f32, which also takes f32 inputs), device ms summed over the "
                    "47 forward and 46 input-gradient launches of one b8 train step with "
                    "conv_kernel=True; library_ms: F.conv2d and its "
                    "input gradient, channels-last, TF32 off"),
        "conv3x3_wgrad": ("cuda", "pti_ldm_vae_tpu_torch/csrc/conv3x3_wgrad.cu",
                          "pti_ldm_vae_tpu/ops/pallas/conv2d.py:137",
                          "bf16, device ms summed over the 47 launches of one b8 train step with "
                          "conv_kernel=True, the torch.sum of the partial sums included; "
                          "library_ms: F.conv2d's filter gradient"),
    }
    f32_sources = {"flash_attention": "pti_ldm_vae_tpu_torch/csrc/flash_attention.cu",
                   "conv3x3": "pti_ldm_vae_tpu_torch/csrc/conv3x3.cu"}
    kernels = []
    for name, (route, source, replaces, scope) in described.items():
        kernels.append({
            "name": name, "route": route, "source": source,
            **({"source_f32": f32_sources[name]} if name in f32_sources else {}),
            "replaces": replaces,
            "launches": adv["launches"][name],
            "launches_by_path": {"inference_vae": bf16["launches"][name],
                                 "inference_vae_conv_kernel": conv_f32["launches"][name],
                                 "train_vae": train["bfloat16"]["launches"][name],
                                 "train_vae_adversarial_conv_kernel": adv["launches"][name]},
            "max_abs_err": errs[name]["bfloat16"], "max_abs_err_f32": errs[name]["float32"],
            **totals(name), "bound_by": rows[name][0]["bound_by"], "scope": scope,
        })
    print(json.dumps({"kernels": kernels}, separators=(",", ":")), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
