"""The port package and the scripts that drive it on the card
(chip_smoke.py, scripts/profile_torch_step.py, scripts/profile_torch_decode.py,
scripts/fast_tier_margin.py)
import neither JAX, flax nor the JAX package ``humanliff_tpu``: a GPU machine
need not have JAX."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "humanliff_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "humanliff_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files.append(os.path.join(REPO, "scripts", "profile_torch_step.py"))
    files.append(os.path.join(REPO, "scripts", "profile_torch_decode.py"))
    files.append(os.path.join(REPO, "scripts", "fast_tier_margin.py"))
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files())
def test_no_forbidden_import_statement(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_training_modules_are_checked():
    files = set(_port_files())
    for module in ("cli/diff_train.py", "train/stage2.py", "train/optim.py",
                   "train/checkpoint.py", "diffusion/losses.py", "diffusion/resample.py",
                   "data/triplane_data.py", "data/loader.py", "utils/logger.py"):
        assert os.path.join("humanliff_tpu_torch", module) in files, module


def test_stage1_modules_are_checked():
    files = set(_port_files())
    for module in ("cli/recon_train.py", "cli/recon_ft.py", "cli/recon_test.py",
                   "train/stage1.py", "train/stage1_ft.py", "train/optim.py",
                   "train/checkpoint.py", "data/synthetic.py", "data/raygen.py",
                   "eval/metrics.py", "eval/harness.py", "utils/config.py",
                   "nerf/renderer.py", "nerf/decoder.py", "compat/from_jax.py"):
        assert os.path.join("humanliff_tpu_torch", module) in files, module


def test_canonical_modules_are_checked():
    files = set(_port_files())
    for module in ("bodymodel/rotations.py", "bodymodel/kinematics.py", "bodymodel/smpl.py",
                   "bodymodel/bigpose.py", "bodymodel/canonical.py", "data/tightcap.py",
                   "data/synbody.py", "data/view_datasets.py", "nerf/fastpath.py",
                   "nerf/geometry.py"):
        assert os.path.join("humanliff_tpu_torch", module) in files, module


def test_quality_modules_are_checked():
    files = set(_port_files())
    for module in ("cli/recon_refit.py", "cli/quality_eval.py", "cli/quality_stage2.py",
                   "cli/bench_decode.py", "eval/fidelity.py", "eval/lpips.py",
                   "eval/metrics.py", "compat/lpips_import.py", "sampling/layered.py"):
        assert os.path.join("humanliff_tpu_torch", module) in files, module


def test_importing_every_port_module_loads_no_jax():
    modules = [p[:-3].replace(os.sep, ".").removesuffix(".__init__")
               for p in _port_files() if p.startswith("humanliff_tpu_torch")]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        + "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
