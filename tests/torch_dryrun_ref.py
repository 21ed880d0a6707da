"""The reference's side of the port's dry-run tests, run as a subprocess
with eight host devices (``tests/conftest.py`` has already started JAX
with one in the test process):

    python tests/torch_dryrun_ref.py JOB.json OUT.json

``JOB.json`` lists cells ``[arch, shape, mesh_shape]`` at smoke width;
``OUT.json`` gets each cell's ``argument_size_in_bytes`` from the
reference's compiled step, keyed ``arch/shape/mesh``.  A (data, model)
mesh goes through the reference's own ``run_cell``; a (pod, data, model)
one, which ``run_cell`` does not take, through its ``make_mesh``,
``cell_shardings`` and the same step builders.  The reference's dry-run
module is loaded as ``tests/test_dryrun_parsing.py`` loads it, without
its 512-device preamble.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_dryrun_parsing import DR  # noqa: E402


def smoke_overrides(arch: str) -> dict:
    """The ArchConfig fields ``smoke_config`` changes, as overrides."""
    from repro.configs import ARCHS, smoke_config

    cfg, small = ARCHS[arch], smoke_config(ARCHS[arch])
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if getattr(small, f.name) != getattr(cfg, f.name)}


def argument_bytes_3d(arch: str, shape_name: str, mesh_shape) -> int:
    import jax

    from repro.launch import mesh as mesh_lib

    cfg = dataclasses.replace(DR.ARCHS[arch], **smoke_overrides(arch))
    shape = DR.SHAPES[shape_name]
    mesh = mesh_lib.make_mesh(tuple(mesh_shape), ("pod", "data", "model"))
    specs = DR.input_specs(cfg, shape)
    sh, rules = DR.cell_shardings(cfg, shape, mesh, specs)
    if shape.kind == "train":
        step, _ = DR.make_train_step(cfg, rules=rules, grad_compression=True)
        args = (specs["params"], specs["opt_state"], specs["error_buf"],
                specs["batch"])
        in_sh = (sh["params"], sh["opt_state"], sh["error_buf"], sh["batch"])
    elif shape.is_decode:
        step = DR.make_serve_step(cfg, rules=rules)
        args = (specs["params"], specs["batch"], specs["cache"])
        in_sh = (sh["params"], sh["batch"], sh["cache"])
    else:
        step = DR.make_prefill_step(cfg, rules=rules)
        args = (specs["params"], specs["batch"])
        in_sh = (sh["params"], sh["batch"])
    with mesh:
        compiled = jax.jit(step, in_shardings=in_sh).lower(*args).compile()
    return int(compiled.memory_analysis().argument_size_in_bytes)


def main(job_path, out_path):
    with open(job_path) as f:
        job = json.load(f)
    out = {}
    for arch, shape, mesh_shape in job:
        if len(mesh_shape) == 2:
            rec = DR.run_cell(arch, shape, False, collect_hlo=False,
                              correct_scan=False,
                              overrides=smoke_overrides(arch),
                              mesh_shape=tuple(mesh_shape))
            n = rec["argument_size_in_bytes"]
        else:
            n = argument_bytes_3d(arch, shape, mesh_shape)
        out[f"{arch}/{shape}/{'x'.join(map(str, mesh_shape))}"] = n
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
