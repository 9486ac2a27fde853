"""pti_ldm_vae_tpu_torch — the PyTorch/CUDA port of ``pti_ldm_vae_tpu``.

Same configs, checkpoints, CLIs and numerics as the JAX package, written in
PyTorch for one NVIDIA H100 (Hopper, ``sm_90a``). The JAX package is the
reference every module here is held to; this package imports neither JAX nor
anything of ``pti_ldm_vae_tpu`` and keeps its own copies of the framework-free
code it needs.

Subpackages mirror the JAX package's layout, so each module has an obvious
counterpart:

- ``config``     JSON config loading with MONAI-compatible ``@ref`` resolution
- ``data``       image IO (numpy TIFF/PNG), host and device transforms, split,
                 loader (native fused TIFF path by default), factories
- ``native``     ctypes bindings of the C++ TIFF decode + resize + z-score
                 (``ptidata.cpp``, built with g++ at first use into ``build/``)
- ``ops``        norm / resize / attention ops; ``ops.kernels`` holds the
                 hand-written Hopper kernels (Triton GroupNorm+SiLU forward and
                 backward, CUDA flash-attention forward and backward), each
                 beside its plain PyTorch version
- ``models``     AutoencoderKL with MONAI parameter names; LPIPS (SqueezeNet)
- ``losses``     KL, reconstruction and total-loss composition
- ``checkpoint`` Flax-tree / MONAI ``.pth`` -> state dict conversion;
                 best/last checkpoint manager (reference ``.pth`` layout); the
                 rule that resolves a checkpoint path (``paths.py``)
- ``utils``      determinism, visualization, logging, model loading, CLI
                 plumbing, profiling (``torch.profiler`` traces, step timing)
- ``train``      train state, train / eval / inference steps, ``VAETrainer``
- ``cli``        entry points (``inference_vae``, ``train_vae``)

Entry points run on CUDA unless the caller passes ``--device cpu``; with no
CUDA device and no explicit ``cpu`` they raise.
"""

__version__ = "0.1.0"
