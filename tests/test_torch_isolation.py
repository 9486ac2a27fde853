"""The PyTorch port stands alone: no JAX, no Flax/Optax/Orbax, nothing of the
JAX package; it imports with JAX unavailable; and it never runs on the CPU
unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pti_ldm_vae_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pti_ldm_vae_tpu")
PORT_FILES = sorted(PORT.rglob("*.py"))


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    for expected in ("cli/inference_vae.py", "cli/train_vae.py", "models/autoencoder_kl.py",
                     "models/lpips.py", "ops/norm.py", "ops/kernels/groupnorm_silu.py",
                     "ops/kernels/flash_attention.py", "losses/kl.py", "losses/composite.py",
                     "utils/losses.py", "utils/logging.py", "train/state.py", "train/steps.py",
                     "train/loop.py", "checkpoint/manager.py", "data/factory.py",
                     "ops/conv.py", "ops/kernels/conv3x3.py", "models/discriminator.py",
                     "losses/adversarial.py", "checkpoint/reference_resume.py",
                     "utils/eval_metrics.py", "cli/evaluate_vae.py", "models/unet.py",
                     "checkpoint/unet_convert.py", "train/diffusion.py",
                     "cli/sample_diffusion.py", "cli/train_diffusion.py", "losses/ar_vae.py",
                     "cli/run_pti.py", "models/regressor.py", "utils/regression_utils.py",
                     "utils/metrics.py", "checkpoint/regressor_convert.py",
                     "cli/train_regression.py", "cli/evaluate_regression.py",
                     "cli/inference_regression.py", "cli/compute_mask_metrics.py",
                     "analysis/__init__.py", "analysis/latent_distance.py",
                     "analysis/latent_cache.py", "analysis/projection.py",
                     "utils/visualization.py", "analysis/latent_space.py",
                     "analysis/common.py", "cli/analyze_static.py",
                     "cli/analyze_interactive.py", "cli/analyze_ar_channels.py",
                     "checkpoint/paths.py", "native/__init__.py", "utils/profiling.py",
                     "parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                     "analysis/metrics.py", "data/augmentation.py", "utils/imgproc.py"):
        assert expected in names
    assert (PORT / "native" / "ptidata.cpp").exists()
    for source in ("flash_attention.cu", "flash_attention_bwd.cu", "conv3x3.cu",
                   "conv3x3_wgrad.cu", "conv3x3_wgmma.cu", "conv3x3_wgrad_wgmma.cu",
                   "flash_attention_wgmma.cu", "flash_attention_bwd_wgmma.cu", "hopper_mma.cuh",
                   "groupnorm_silu_fwd.cu", "groupnorm_silu_bwd.cu", "groupnorm_silu.cuh"):
        assert (PORT / "csrc" / source).exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_has_no_forbidden_imports():
    test_no_forbidden_imports(ROOT / "chip_smoke.py")


def test_port_imports_with_jax_blocked():
    modules = sorted(
        "pti_ldm_vae_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT_FILES if p.name != "__init__.py"
    )
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (f"import sys; {blocked}\n"
            f"import importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"assert 'triton' not in sys.modules\n"
            f"print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_analysis_imports_without_the_optional_host_packages():
    """The card's machine has none of scikit-learn, matplotlib, plotly, dash,
    umap-learn, OpenCV, pandas and albumentations: the analysis package, its
    three CLIs, the comparison suite and the paired augmentation import with
    them blocked, and import none of them."""
    blocked = ("sklearn", "matplotlib", "plotly", "dash", "umap", "cv2", "pandas",
               "albumentations")
    code = (
        "import sys\n"
        f"BLOCKED = {blocked!r}\n"
        "class Blocker:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ModuleNotFoundError(f'No module named {name!r}')\n"
        "sys.meta_path.insert(0, Blocker())\n"
        "import importlib\n"
        "for m in ('pti_ldm_vae_tpu_torch.analysis', 'pti_ldm_vae_tpu_torch.cli.analyze_static',\n"
        "          'pti_ldm_vae_tpu_torch.cli.analyze_interactive',\n"
        "          'pti_ldm_vae_tpu_torch.cli.analyze_ar_channels',\n"
        "          'pti_ldm_vae_tpu_torch.analysis.metrics',\n"
        "          'pti_ldm_vae_tpu_torch.data.augmentation'):\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_without_device_cpu_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from pti_ldm_vae_tpu_torch.cli.inference_vae import main

    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["-c", "unused.json", "--checkpoint", "unused.pth", "--input-dir", str(tmp_path)])
