"""The dry run's per-rank ``argument_size_in_bytes`` against the
reference's compiled cell, byte for byte, at smoke width: every
applicable shape of deepseek-v2-lite-16b and falcon-mamba-7b on (data, model) (2, 2).

The reference compiles each cell in one subprocess for the module
(``tests/torch_dryrun_ref.py``, eight host devices), started before the
first test and read at the first comparison; the port places the same
cell's inputs as DTensors on the meta device in a fake world of the
mesh's size.  The cells are split over seven modules (``_a`` to ``_g``)
so that each module's reference compiles stay near half a minute.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cases import (  # noqa: E402
    Reference, arch_cells, cell_id, port_argument_bytes,
)

CELLS = arch_cells(("deepseek-v2-lite-16b", "falcon-mamba-7b"), (2, 2))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return Reference(tmp_path_factory.mktemp("dryrun_ref"), CELLS)


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[cell_id(*c) for c in CELLS])
def test_argument_bytes_equal_reference(reference, arch, shape, mesh):
    got = port_argument_bytes(arch, shape, mesh)
    assert got == reference()[cell_id(arch, shape, mesh)]
