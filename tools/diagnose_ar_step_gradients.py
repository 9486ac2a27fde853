#!/usr/bin/env python3
"""Where an f32 AR-VAE train step on the card parts from the CPU plain path.

    python3 tools/diagnose_ar_step_gradients.py     # needs one CUDA card; ~1 minute

For ``config/ar_vae_dente_kl1e3.json`` and ``config/ar_vae_dente.json`` at
256², batch 2, random weights from a seed (the models of
``chip_smoke.py:ar_step_reference_check``), prints one JSON line per config:

- ``blocks``: per decoder block (and ``post_quant_conv``), the largest
  difference of its output and of the gradient at its output, card f32
  against the CPU, over that tensor's largest entry, under a plain MSE loss
  of the reconstruction;
- ``worst_step_gradients``: the six parameter gradients of the whole AR
  step (L1, KL, LPIPS, AR term) that differ most, card against CPU, of each
  tensor's largest entry, with the convolution kernels and with cuDNN;
- ``cpu_order_noise``: the same six worst for the CPU against itself with
  one thread instead of all (f32 summation order alone).
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SIZE = 256  # the configs' patch size


def worst(a: dict, b: dict, n: int = 6) -> list:
    errs = [(float((a[k] - b[k]).abs().max()) / float(b[k].abs().max()), k)
            for k in b if not k.endswith("to_k.bias")]  # 0 in exact arithmetic
    return sorted(errs, reverse=True)[:n]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.loop import build_ar_spec, resolve_ar_settings
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses

    if not torch.cuda.is_available():
        print("diagnose_ar_step_gradients: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    data = ROOT / "build" / "diagnose_ar" / "dente"
    if not data.exists():
        cs.write_inputs(np, data, 2)
    images = torch.from_numpy(np.stack([preprocess_image_np(read_image(str(p)), (SIZE, SIZE))
                                        for p in sorted(data.glob("*.tif"))]))
    mask = torch.ones(2)
    for config in (cs.KL1E3_CONFIG, cs.AR_CONFIG):
        cfg = load_config(config)
        ae = cfg["autoencoder_def"]
        spec = build_ar_spec(cfg, resolve_ar_settings(cfg))
        attrs = {name: torch.tensor([0.3, 0.9]) for name in spec.names}
        side = SIZE // 2 ** (len(ae["channels"]) - 1)
        eps = torch.randn(2, side, side, ae["latent_channels"],
                          generator=torch.Generator().manual_seed(8))
        lcfg = LossConfig(ar_gamma=0.5, ar_vae_enabled=True, ar_spec=spec)

        def step_grads(model, device):
            total, _ = _generator_losses(model, lcfg, init_lpips_params(0, device),
                                         images.to(device), mask.to(device), eps.to(device),
                                         None, None, {k: v.to(device) for k, v in attrs.items()})
            total.backward()
            return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

        def block_errors(cpu_model, gpu_model):
            out = {}
            for model, device in ((gpu_model, "cuda"), (cpu_model, "cpu")):
                acts, grads, hooks = {}, {}, []
                blocks = list(model.decoder.blocks.named_children())
                for name, mod in blocks + [("post_quant_conv", model.post_quant_conv)]:
                    def hook(m, args, y, name=name):
                        acts[name] = y.detach().float().cpu()
                        y.register_hook(lambda g, name=name: grads.__setitem__(
                            name, g.detach().float().cpu()))
                    hooks.append(mod.register_forward_hook(hook))
                recon = model(images.to(device), eps.to(device))[0]
                recon.float().square().mean().backward()
                for h in hooks:
                    h.remove()
                out[device] = (acts, grads)
            (a1, g1), (a0, g0) = out["cuda"], out["cpu"]
            return {k: [float((a1[k] - a0[k]).abs().max() / a0[k].abs().max()),
                        float((g1[k] - g0[k]).abs().max() / g0[k].abs().max())] for k in a0}

        torch.manual_seed(7)
        base = autoencoder_from_config(ae)
        result = {"config": config.name,
                  "blocks": block_errors(copy.deepcopy(base), copy.deepcopy(base).to("cuda"))}
        result["worst_step_gradients"] = {}
        for conv_kernel in (True, False):
            torch.manual_seed(7)
            cpu = autoencoder_from_config(ae, conv_kernel=conv_kernel)
            gpu = copy.deepcopy(cpu).to(device="cuda", memory_format=torch.channels_last)
            result["worst_step_gradients"][f"conv_kernel={conv_kernel}"] = worst(
                step_grads(gpu, "cuda"), step_grads(cpu, "cpu"))
        threads = torch.get_num_threads()
        many = step_grads(copy.deepcopy(base), "cpu")
        torch.set_num_threads(1)
        one = step_grads(copy.deepcopy(base), "cpu")
        torch.set_num_threads(threads)
        result["cpu_order_noise"] = {"threads": [threads, 1], "worst": worst(many, one)}
        print(json.dumps(result, separators=(",", ":")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
