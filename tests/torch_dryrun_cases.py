"""Cells of the port's dry-run tests (no JAX): the smoke-width overrides
of an arch, the cells of each argument-bytes test module, and the
reference's subprocess (``tests/torch_dryrun_ref.py``) started for a
module's cells and read back."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REF_TIMEOUT = 600
SSM = ("falcon-mamba-7b", "zamba2-7b")     # the slowest cells to trace


def smoke_overrides(arch: str) -> dict:
    """The ArchConfig fields ``smoke_config`` changes, as ``run_cell``
    overrides (the reference's ``run_cell`` takes the same)."""
    from repro_torch.configs import ARCHS, smoke_config

    cfg, small = ARCHS[arch], smoke_config(ARCHS[arch])
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(cfg, f.name)}


def all_cells() -> list:
    from repro_torch.launch.dryrun import cells

    return list(cells())


def cell_id(arch, shape, mesh) -> str:
    return f"{arch}/{shape}/{'x'.join(map(str, mesh))}"


def start_reference(tmp, cells) -> tuple:
    """The reference's subprocess for ``cells`` (``[arch, shape, mesh]``),
    started now; read it with :func:`reference_result`."""
    tmp = str(tmp)
    job, out = os.path.join(tmp, "job.json"), os.path.join(tmp, "ref.json")
    with open(job, "w") as f:
        json.dump([[a, s, list(m)] for a, s, m in cells], f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dryrun_ref.py"), job, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def reference_result(started) -> dict:
    proc, out = started
    try:
        log, _ = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        raise AssertionError(f"the reference's dry run timed out:\n{log[-3000:]}")
    if proc.returncode:
        raise AssertionError(f"the reference's dry run failed "
                             f"({proc.returncode}):\n{log[-3000:]}")
    with open(out) as f:
        return json.load(f)


class Reference:
    """The reference's subprocess for a module's cells, read once."""

    def __init__(self, tmp, cells):
        self.started = start_reference(tmp, cells)
        self._result = None

    def __call__(self) -> dict:
        if self._result is None:
            self._result = reference_result(self.started)
        return self._result


def arch_cells(archs, mesh) -> list:
    """Every applicable shape of ``archs`` on ``mesh``."""
    return [(a, s, tuple(mesh)) for a, s in all_cells() if a in archs]


def port_argument_bytes(arch, shape, mesh) -> int:
    """The port's ``argument_size_in_bytes`` of a smoke-width cell, from
    the inputs ``run_cell`` places, in a fake world of the mesh's size."""
    import torch

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(ARCHS[arch], **smoke_overrides(arch))
    world = 1
    for n in mesh:
        world *= n
    dev = torch.device("meta")
    with dryrun.fake_world(world):
        m, _ = dryrun._mesh(len(mesh) == 3, tuple(mesh), dev)
        args, _ = dryrun.cell_inputs(cfg, SHAPES[shape], m, dev)
        return dryrun.argument_bytes(args, cfg)
