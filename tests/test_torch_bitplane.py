"""Port vs reference: bit-plane pack (kernel's plain version), plane
unpack, precision views and the KV transform — byte identity throughout.

The CUDA pack kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``); here the
wrapper takes its plain version, because the tensors lie on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitplane as rbit  # noqa: E402
from repro.core import kv_transform as rkv  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.kernels import bitplane as rkbit  # noqa: E402
from repro_torch.core import bitplane as tbit  # noqa: E402
from repro_torch.core import kv_transform as tkv  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.kernels import bitplane as tkbit  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SPECIALS = np.array([0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x7F81, 0x8000, 0x0000,
                     0x0001, 0x807F, 0x7F7F], dtype=np.uint16)


def _u16(n, seed=0):
    """Random bf16 patterns (KV-like magnitudes) with NaN/Inf/±0/subnormals."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(n) * 0.7).astype(np.float32)
    u = (f.view(np.uint32) >> 16).astype(np.uint16)
    u[rng.integers(0, n, max(n // 16, 1))] = rng.choice(SPECIALS,
                                                         max(n // 16, 1))
    return u


def _t(u16):
    return torch.from_numpy(u16.view(np.int16).copy())


@pytest.mark.parametrize("n", [256, 4096, 24576])
def test_plain_pack_matches_pallas_and_numpy(n):
    x = _u16(n, seed=n)
    got = tkbit.pack_planes_plain(_t(x)).numpy()
    np.testing.assert_array_equal(got, rbit.pack_planes(x))
    pallas = rkbit.pack_planes_pallas(jnp.asarray(x.reshape(-1, 256)),
                                      block_r=1, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas).reshape(16, n // 8))


def test_pack_wrapper_on_cpu_takes_plain_and_counts_nothing():
    x = _u16(2048, seed=3)
    before = build.LAUNCHES["bitplane_pack"]
    out = tkbit.pack_planes_u16(_t(x))
    assert build.LAUNCHES["bitplane_pack"] == before
    np.testing.assert_array_equal(out.numpy(), rbit.pack_planes(x))
    # uint16 tensors are accepted as well as int16
    out16 = tkbit.pack_planes_u16(_t(x).view(torch.uint16))
    assert torch.equal(out16, out)
    # the slab entry point packs numpy on the given device, as the
    # reference's slab dispatcher does
    slab = tkbit.pack_planes_slab(x, torch.device("cpu"))
    np.testing.assert_array_equal(slab.numpy(),
                                  rkbit.pack_planes_slab(x, force="numpy"))


@pytest.mark.parametrize("bad", [
    lambda: torch.zeros(16, dtype=torch.float32),
    lambda: torch.zeros(12, dtype=torch.int16),
    lambda: torch.zeros((2, 8), dtype=torch.int16),
])
def test_pack_wrapper_rejects_bad_inputs(bad):
    with pytest.raises((TypeError, ValueError)):
        tkbit.pack_planes_u16(bad())


def test_unpack_and_subset_match_reference():
    x = _u16(4096, seed=9)
    planes = rbit.pack_planes(x)
    np.testing.assert_array_equal(tbit.unpack_planes(planes, x.size), x)
    for view in list(rprec.VIEWS.values()) + [rprec.SCORE]:
        idx = view.fetched_planes()
        rows = planes[list(idx)]
        np.testing.assert_array_equal(
            tbit.unpack_planes_subset(rows, idx, x.size),
            rbit.unpack_planes_subset(rows, idx, x.size))


@pytest.mark.parametrize("name", ["bf16", "man4", "man2", "man0", "score"])
def test_reconstruct_and_truncate_identical_over_views(name):
    rview = rprec.SCORE if name == "score" else rprec.VIEWS[name]
    tview = tprec.SCORE if name == "score" else tprec.VIEWS[name]
    assert (tview.r_e, tview.r_m, tview.d_e, tview.d_m) == \
        (rview.r_e, rview.r_m, rview.d_e, rview.d_m)
    assert tview.fetched_planes() == rview.fetched_planes()
    assert tview.kept_planes() == rview.kept_planes()
    assert tview.bits == rview.bits and tview.plane_mask() == rview.plane_mask()
    x = np.concatenate([_u16(8192, seed=11),
                        np.arange(0, 1 << 16, 7, dtype=np.uint16)])
    np.testing.assert_array_equal(tprec.reconstruct_u16(x, tview),
                                  rprec.reconstruct_u16(x, rview))
    np.testing.assert_array_equal(tprec.truncate_reference(x, tview),
                                  rprec.truncate_reference(x, rview))
    assert tprec.view_dram_bytes(4096, tview) == \
        rprec.view_dram_bytes(4096, rview)


@pytest.mark.parametrize("shape", [(3, 64, 128), (1, 16, 64), (5, 7, 24)])
def test_kv_transform_batch_identical(shape):
    B, n, C = shape
    rng = np.random.default_rng(B * n + C)
    w = ((rng.standard_normal(shape) * np.exp(rng.uniform(-4, 4, (1, 1, C))))
         .astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    w.reshape(-1)[:: 97] = 0x7FC0
    ts, tm = tkv.kv_forward_batch(w)
    rs, rm = rkv.kv_forward_batch(w)
    np.testing.assert_array_equal(ts, rs)
    for a, b in zip(tm, rm):
        np.testing.assert_array_equal(a.beta, b.beta)
        assert (a.n_tokens, a.n_channels) == (b.n_tokens, b.n_channels)
    np.testing.assert_array_equal(tkv.kv_inverse_batch(ts, tm), w)
    np.testing.assert_array_equal(tkv.kv_inverse_batch(ts, tm),
                                  rkv.kv_inverse_batch(rs, rm))
    # per-window forms agree with the batch
    s0, m0 = tkv.kv_forward(w[0])
    np.testing.assert_array_equal(s0, ts[0])
    np.testing.assert_array_equal(tkv.kv_inverse(s0, m0), w[0])
