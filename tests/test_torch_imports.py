"""The port stands alone: no module of ``atomo_tpu_torch``, not
``chip_smoke.py`` and not the multi-rank tests' worker (``tests/torch_dist.py``)
imports JAX, Flax, optax or the JAX package, and its entry points never drop
to the CPU by themselves."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "atomo_tpu")
# the port, its smoke script, and the multi-rank tests' worker (the test
# process computes the JAX side and hands the workers numpy arrays)
SOURCES = sorted((ROOT / "atomo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                              ROOT / "tests" / "torch_dist.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert path.exists(), path
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_sources_hold_the_slice_modules():
    """The trace-based timeline, the measured fabric, the online budget
    re-allocation, the partitioned update with its reshard, the quorum
    family with its survivor-exact mean, and the topology layer (the
    two-tier fabric, the planner, the plans' execution) are among the
    checked sources, each a module of its own; ``chip_smoke.py``, whose
    ``--topology-gloo-child`` mode runs the two-tier step on the card, is
    one too."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"atomo_tpu_torch/obs/timeline.py", "atomo_tpu_torch/obs/fabric.py",
            "atomo_tpu_torch/budget/retune.py", "atomo_tpu_torch/utils/tracing.py",
            "atomo_tpu_torch/mesh/update.py", "atomo_tpu_torch/mesh/reshard.py",
            "atomo_tpu_torch/quorum/__init__.py", "atomo_tpu_torch/quorum/schedule.py",
            "atomo_tpu_torch/quorum/artifact.py", "atomo_tpu_torch/quorum/rig.py",
            "atomo_tpu_torch/elastic/__init__.py", "atomo_tpu_torch/elastic/shrink.py",
            "atomo_tpu_torch/topology/__init__.py", "atomo_tpu_torch/topology/fabric.py",
            "atomo_tpu_torch/topology/schedule.py", "atomo_tpu_torch/topology/execute.py",
            "chip_smoke.py"} <= names
    assert "--topology-gloo-child" in (ROOT / "chip_smoke.py").read_text()


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "atomo_tpu_torch").rglob("*.py")
        if p.name != "__main__.py"
    )
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_refuse_to_fall_back_to_cpu():
    from atomo_tpu_torch import cli
    from atomo_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
                  "--max-steps", "1"], log_fn=lambda line: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["lm", "--layout", "dp-sp", "--ways", "1", "--attn-impl", "ulysses-flash",
                  "--max-steps", "1"], log_fn=lambda line: None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_versions_on_cpu_only():
    """On a CPU tensor a wrapper runs its plain version and counts nothing."""
    from atomo_tpu_torch.ops import qsgd_kernels as K

    K.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(700).astype(np.float32))
    words, scales = K.quantize_pack(x, bits=4, seeds=[7])
    K.unpack_dequantize(words, scales, bits=4, n=700)
    codes = K.unpack_bucketed(words, 4)
    K.pack_bucketed(codes, 4)
    assert K.launch_counts() == {name: 0 for name in K.launch_counts()}
    with pytest.raises(ValueError, match="no QSGD kernel"):
        K.quantize_pack(x.to("meta"), bits=4, seeds=[7])


def test_cli_trains_on_cpu_when_asked():
    from atomo_tpu_torch import cli

    lines = []
    state = cli.main(["train", "--network", "LeNet", "--dataset", "MNIST", "--synthetic",
                      "--batch-size", "16", "--max-steps", "2", "--log-interval", "1",
                      "--eval-freq", "0", "--code", "qsgd", "--device", "cpu"],
                     log_fn=lines.append)
    assert state == 0
    worker = [ln for ln in lines if ln.startswith("Worker: 0, Step: ")]
    assert len(worker) == 2
    losses = [float(ln.split("Loss: ")[1].split(",")[0]) for ln in worker]
    assert all(np.isfinite(losses))
