"""The port stands alone: no JAX, no reference package, card by default.

* every module of `kube_batch_tpu_torch` imports in a fresh interpreter
  with `jax`, `flax` and `kube_batch_tpu` blocked in `sys.modules` (this
  test process has imported jax already, hence the subprocess);
* no file of the package, nor chip_smoke.py, nor a port script
  (scripts/*torch*.py) names them in an import, but the port scripts
  that compare both packages on the CPU by design (BOTH_PACKAGES);
* the entry points raise without a CUDA device unless the caller passes
  device="cpu".
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "kube_batch_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "kube_batch_tpu"}
PORT_SCRIPTS = sorted((ROOT / "scripts").glob("*torch*.py"))
#: port scripts that run both packages on the CPU by design, as the tests do
BOTH_PACKAGES = {"check_torch_preempt_config4.py"}

_IMPORT_ALL = """
import sys
for name in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import kube_batch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kube_batch_tpu_torch.__path__, "kube_batch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in {k for k, v in sys.modules.items() if v is not None}
print(len(names))
"""


def test_package_imports_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_imports_jax_or_reference(path):
    assert not (_imported_roots(path) & FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in PORT_SCRIPTS if p.name not in BOTH_PACKAGES],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_port_script_imports_jax_or_reference(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_both_package_scripts_are_the_declared_ones():
    """A port script that imports the reference is one of BOTH_PACKAGES,
    and each of those exists and does compare the two packages."""
    both = {p.name for p in PORT_SCRIPTS if _imported_roots(p) & FORBIDDEN}
    assert both == BOTH_PACKAGES


def test_scheduler_without_device_needs_cuda(monkeypatch):
    from kube_batch_tpu_torch.models.workloads import build_config
    from kube_batch_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache, _ = build_config(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(cache)
    sched = Scheduler(cache, device="cpu")
    assert sched.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cli_without_device_needs_cuda(monkeypatch):
    from kube_batch_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--workload", "1", "--cycles", "1"])
    assert main(["--workload", "1", "--cycles", "1", "--device", "cpu"]) == 0


def test_cli_joint_solve_and_affinity_workload(capsys, monkeypatch):
    """`--joint-solve on` runs the joint cycle and says so; the affinity
    workload runs (here cut to 16 nodes and 120 pods) on the CPU."""
    import functools
    import json

    from kube_batch_tpu_torch.__main__ import main
    from kube_batch_tpu_torch.models import workloads

    assert main(["--workload", "1", "--cycles", "1", "--device", "cpu",
                 "--joint-solve", "on"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cycle_kind"] == "joint" and line["bound"] == 8
    assert [t["tier"] for t in line["joint_tiers"]] == [
        "allocate:idle", "allocate:future", "backfill"]
    monkeypatch.setattr(workloads, "config5_affinity", functools.partial(
        workloads.config5_affinity, n_nodes=16, target_pods=120))
    assert main(["--workload", "affinity", "--cycles", "1", "--device", "cpu",
                 "--joint-solve", "off"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cycle_kind"] == "sequential" and line["bound"] > 0


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the CUDA kernels refuse to build (no silent fallback)."""
    from kube_batch_tpu_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("resolve")


def test_incremental_packer_without_device_needs_cuda(monkeypatch):
    from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
    from kube_batch_tpu_torch.models.workloads import build_config
    from kube_batch_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache, _ = build_config(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalPacker(cache)
    sched = Scheduler(cache, device="cpu")
    assert sched.pack_mode == "incremental" and not sched.packer.force_full
    assert sched.packer.device.type == "cpu"
    with pytest.raises(ValueError, match="pack_mode"):
        Scheduler(cache, device="cpu", pack_mode="loop")


def test_rank_and_row_patch_wrappers_refuse_other_devices():
    """K8 and K9 run their plain versions only for CPU tensors; a tensor
    on any other device than the CPU or a CUDA card is refused."""
    import numpy as np

    from kube_batch_tpu_torch.kernels import lex_rank as k8
    from kube_batch_tpu_torch.kernels import row_patch as k9

    meta = torch.device("meta")
    idx = torch.zeros(4, dtype=torch.int64, device=meta)
    key = torch.zeros(4, device=meta)
    with pytest.raises(RuntimeError):
        k8.lex_push(idx, key)
    with pytest.raises(RuntimeError):
        k8.sort_by_segment(idx.int(), idx.int(), 2)
    with pytest.raises(RuntimeError):
        k8.vtime(idx.int(), idx.int(), torch.zeros((4, 4), device=meta), key.bool(),
                 torch.zeros((2, 4), device=meta), torch.zeros((2, 4), device=meta), 2)
    with pytest.raises(RuntimeError):
        k9.row_patch([key], [np.zeros(4, np.float32)], [np.zeros(2, np.int32)])


@pytest.mark.parametrize("module", [
    "kube_batch_tpu_torch.cache.incremental",
    "kube_batch_tpu_torch.kernels.lex_rank",
    "kube_batch_tpu_torch.kernels.row_patch",
    "kube_batch_tpu_torch.kernels.affinity",
    "kube_batch_tpu_torch.kernels.resident",
    "kube_batch_tpu_torch.kernels.joint_tier",
    "kube_batch_tpu_torch.ops.joint",
    "kube_batch_tpu_torch.actions.fused",
])
def test_host_cycle_modules_import_alone(module):
    """The modules the host-cycle, affinity and joint-solve slices add
    import with JAX and the reference package blocked, without nvcc,
    triton or a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    code = ('import sys\n'
            'for n in ("jax", "jaxlib", "flax", "kube_batch_tpu", "triton"):\n'
            '    sys.modules[n] = None\n'
            f'import {module}\n')
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
