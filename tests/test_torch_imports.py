"""Import guard: the port (`src/repro_torch`), `chip_smoke.py` and the
port's examples (`examples/torch_*.py`) import nothing of JAX and nothing
of the reference package `repro`."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    code = (
        "import repro_torch.convserve, repro_torch.core, repro_torch.models, "
        "repro_torch.serve, repro_torch.launch.serve; import sys; "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "or m == 'repro' for m in sys.modules), sorted(sys.modules)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


# the modules of the later slices: the online runtime, obs and the
# measuring tune; then the adapt loop, check and fused Winograd; then
# the fleet; then training; then the conv1d backward; then the MoE layer
NEW_MODULES = (
    "repro_torch.convserve.obs",
    "repro_torch.convserve.obs.trace",
    "repro_torch.convserve.obs.roofline",
    "repro_torch.convserve.obs.export",
    "repro_torch.convserve.runtime.telemetry",
    "repro_torch.convserve.runtime.loadgen",
    "repro_torch.convserve.runtime.replicas",
    "repro_torch.convserve.runtime.service",
    "repro_torch.core.tune",
    "repro_torch.kernels.bitwise_check",
    # the adapt loop, static verification and the fused Winograd slice
    "repro_torch.convserve.adapt",
    "repro_torch.convserve.adapt.costs",
    "repro_torch.convserve.adapt.shadow",
    "repro_torch.convserve.adapt.swap",
    "repro_torch.convserve.adapt.replanner",
    "repro_torch.convserve.check.ir",
    "repro_torch.convserve.check.locks",
    "repro_torch.convserve.check.rules",
    "repro_torch.convserve.check.__main__",
    "repro_torch.kernels.fused_winograd",
    "repro_torch.kernels.fused_winograd.ops",
    "repro_torch.kernels.fused_winograd.ref",
    "repro_torch.core.pipeline",
    # the elastic fleet, the fault schedule and the sharding rule engine
    "repro_torch.convserve.fleet",
    "repro_torch.convserve.fleet.sharding",
    "repro_torch.convserve.fleet.pool",
    "repro_torch.convserve.fleet.autoscaler",
    "repro_torch.convserve.fleet.service",
    "repro_torch.runtime",
    "repro_torch.runtime.fault",
    "repro_torch.distributed",
    "repro_torch.distributed.sharding",
    # training: the flash backward, AdamW, data, checkpoints, step, loop,
    # launcher
    "repro_torch.kernels.flash_attention.backward",
    "repro_torch.models.flash_attention",
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.io",
    "repro_torch.train",
    "repro_torch.train.step",
    "repro_torch.train.loop",
    "repro_torch.launch.train",
    "repro_torch.kernels.conv1d_fused.backward",
    "repro_torch.models.moe",
    # the dry run: specs, meshes, the op counter, the launchers; the
    # kernels' meta branches
    "repro_torch.kernels.meta",
    "repro_torch.launch.specs",
    "repro_torch.launch.mesh",
    "repro_torch.launch.hlo_analysis",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.inspect_cell",
    # the runtime flags and the compressed all-reduce
    "repro_torch.models.runtime_flags",
    "repro_torch.distributed.collectives",
)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_is_checked_file_by_file(module):
    """Each new module's source is among the files the AST guard reads."""
    rel = pathlib.Path("src", *module.split("."))
    assert (ROOT / rel).with_suffix(".py") in FILES or (ROOT / rel / "__init__.py") in FILES


def test_importing_the_new_modules_loads_no_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    code = (
        f"import importlib, sys; [importlib.import_module(m) for m in {NEW_MODULES!r}]; "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "or m == 'repro' for m in sys.modules), sorted(sys.modules)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
