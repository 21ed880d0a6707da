"""Every (arch × applicable shape) cell but the SSM families' in the dry
run, at smoke width, on a fake world of 16 ranks as (data, model) (4,
4): an ``ok`` record with the reference's keys where the quantity is the
same, FLOPs, bytes and a peak, collectives whose counts and bytes add
up, the trip count, and the kernel calls of a decode cell (one a layer
with a linear cache). A world a cell, started and destroyed by
``run_cell``; those are in ``test_torch_dryrun_cells16_ssm.py``, so each
module stays near a minute."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_dryrun_cases import SSM, all_cells, smoke_overrides  # noqa: E402

MESH = (4, 4)
CELLS = [(a, s) for a, s in all_cells() if a not in SSM]
KEYS = ("arch", "shape", "mesh", "chips", "kind", "argument_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes", "device_bytes_total",
        "collectives", "scan_trip_count", "trace_s", "flops",
        "bytes_accessed", "kernel_calls")


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_cell_traces(arch, shape):
    rec = dryrun.run_cell(arch, shape, False, overrides=smoke_overrides(arch),
                          mesh_shape=MESH)
    assert all(k in rec for k in KEYS)
    assert rec["mesh"] == "x".join(map(str, MESH)) and rec["chips"] == 16
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["temp_size_in_bytes"] > 0 and rec["argument_size_in_bytes"] > 0
    assert rec["device_bytes_total"] == (rec["argument_size_in_bytes"]
                                         + rec["temp_size_in_bytes"])
    c = rec["collectives"]
    assert c["total"] == sum(c[k] for k in dryrun.COLLECTIVES) > 0
    assert rec["scan_trip_count"] == dryrun.scan_trip_count(
        dryrun.dataclasses.replace(ARCHS[arch], **smoke_overrides(arch)))
    cfg = ARCHS[arch]
    attends = shape in ("decode_32k", "long_500k") and not cfg.mla \
        and cfg.family not in ("ssm", "hybrid")
    assert (rec["kernel_calls"] > 0) == attends
