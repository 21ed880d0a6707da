"""Port vs reference: the kernel API (``repro_torch.kernels.ops``) against
``repro.kernels.ops`` (Pallas kernels in interpret mode) and the jnp
oracles of ``repro.kernels.ref``.

Inputs are made from a numpy seed and handed to both.  Integer paths
(pack, unpack at every view, the KV transform) are byte-identical; the
elastic matmul agrees at the reference test's tolerance (rtol = atol =
1e-5: bf16 x bf16 products are exact in f32, only the order of the f32
sum differs), and its full view equals the dense product.  On CPU
tensors every function takes its kernel's plain version and counts no
launch; the CUDA kernels run on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import precision as rprec  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import elastic_matmul as tmm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand_u16(rng, shape):
    u = rng.integers(0, 1 << 16, size=shape).astype(np.uint16)
    idx = rng.integers(0, u.size, size=max(u.size // 64, 1))
    flat = u.reshape(-1)
    flat[idx[::2]] = 0x7FC0
    flat[idx[1::2]] = 0xFF80
    return u


def _t(u16):
    return torch.from_numpy(np.ascontiguousarray(u16).view(np.int16).copy())


def _u(t):
    return t.numpy().view(np.uint16)


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values for both packages: a jnp array and a tensor."""
    f = (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)
    return (jnp.asarray(f),
            torch.from_numpy(f.view(np.int16).copy()).view(torch.bfloat16))


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    before = dict(build.LAUNCHES)
    yield
    assert build.LAUNCHES == before


@pytest.mark.parametrize("shape", [(8, 128), (64, 256), (32, 8)])
def test_pack_and_full_unpack_match_reference(shape):
    x = _rand_u16(np.random.default_rng(0), shape)
    planes = ops.bitplane_pack(_t(x))
    assert planes.shape == (16, shape[0], shape[1] // 8)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(rops.bitplane_pack(jnp.asarray(x))))
    np.testing.assert_array_equal(_u(ops.elastic_unpack(planes)), x)


@pytest.mark.parametrize("r_e,r_m,d_m", [(8, 7, 0), (8, 4, 1), (8, 2, 1),
                                         (8, 0, 1), (8, 3, 0), (8, 0, 0),
                                         (8, 2, 3), (6, 3, 1)])
@pytest.mark.parametrize("shape", [(64, 256), (8, 128)])
def test_elastic_unpack_matches_reference_every_view(shape, r_e, r_m, d_m):
    x = _rand_u16(np.random.default_rng(2), shape)
    x.reshape(-1)[::37] = 0x407F           # carries into the exponent
    x.reshape(-1)[1::41] = 0x7F7F          # saturates at Inf
    x.reshape(-1)[2::43] = 0x7F81          # NaN, payload in a low plane
    jplanes = rops.bitplane_pack(jnp.asarray(x))
    got = _u(ops.elastic_unpack(ops.bitplane_pack(_t(x)), r_e, r_m, d_m))
    np.testing.assert_array_equal(got, np.asarray(rops.elastic_unpack(
        jplanes, r_e=r_e, r_m=r_m, d_m=d_m)))
    np.testing.assert_array_equal(got, np.asarray(rref.elastic_unpack_ref(
        jplanes, r_e, r_m, d_m)))
    if r_e == 8:
        view = rprec.PrecisionView(r_e=8, r_m=r_m, d_m=d_m)
        np.testing.assert_array_equal(
            got, rprec.truncate_reference(x.ravel(), view).reshape(shape))


def test_kv_transform_and_inverse_match_reference():
    rng = np.random.default_rng(7)
    kv = _rand_u16(rng, (64, 128))
    beta = rng.integers(0, 256, 128).astype(np.uint8)
    jb = jnp.asarray(beta.astype(np.int32))
    cm = ops.kv_transform(_t(kv), torch.from_numpy(beta))
    jcm = rops.kv_transform(jnp.asarray(kv), jb)
    np.testing.assert_array_equal(_u(cm), np.asarray(jcm))
    back = ops.kv_transform_inv(cm, torch.from_numpy(beta))
    np.testing.assert_array_equal(_u(back), np.asarray(
        rops.kv_transform_inv(jcm, jb)))
    np.testing.assert_array_equal(_u(back), kv)


@pytest.mark.parametrize("M,K,N", [(8, 64, 128), (16, 512, 256),
                                   (128, 128, 128), (3, 24, 40)])
def test_pack_weights_kmajor_matches_reference(M, K, N):
    jw, tw = _bf16(np.random.default_rng(K + N), (K, N))
    np.testing.assert_array_equal(tmm.pack_weights_kmajor(tw).numpy(),
                                  np.asarray(rref.pack_weights_kmajor(jw)))


@pytest.mark.parametrize("M,K,N", [(8, 64, 128), (16, 512, 256),
                                   (128, 128, 128)])
@pytest.mark.parametrize("r_m,d_m", [(7, 0), (4, 1), (0, 1)])
def test_elastic_matmul_matches_reference(M, K, N, r_m, d_m):
    rng = np.random.default_rng(M * K + N)
    jx, tx = _bf16(rng, (M, K))
    jw, tw = _bf16(rng, (K, N))
    jplanes = rref.pack_weights_kmajor(jw)
    got = ops.elastic_matmul(tx, tmm.pack_weights_kmajor(tw), r_m, d_m)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = np.asarray(rops.elastic_matmul(jx, jplanes, r_m=r_m, d_m=d_m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        rref.elastic_matmul_ref(jx, jplanes, r_m, d_m)), rtol=1e-5, atol=1e-5)


def test_elastic_matmul_full_view_equals_dense():
    rng = np.random.default_rng(1)
    _, x = _bf16(rng, (16, 256))
    _, w = _bf16(rng, (256, 128))
    got = ops.elastic_matmul(x, tmm.pack_weights_kmajor(w), 7, 0)
    np.testing.assert_allclose(got.numpy(), (x.float() @ w.float()).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_elastic_matmul_precision_degrades_gracefully():
    rng = np.random.default_rng(2)
    _, x = _bf16(rng, (32, 512))
    _, w = _bf16(rng, (512, 256))
    planes = tmm.pack_weights_kmajor(w)
    dense = (x.float() @ w.float()).numpy()
    errs = [np.abs(ops.elastic_matmul(x, planes, r_m, 1).numpy() - dense).mean()
            for r_m in (7, 4, 2, 0)]
    assert errs[0] <= errs[1] <= errs[2] <= errs[3] + 1e-6
    assert errs[3] / (np.abs(dense).mean() + 1e-9) < 0.35


@pytest.mark.parametrize("r_m,d_m", [(7, 0), (4, 1), (0, 0)])
def test_elastic_matmul_hands_the_stack_in_place(monkeypatch, r_m, d_m):
    """``ops.elastic_matmul`` gives the kernel wrapper the stack's own top
    planes (a view, no copy) with their ids, so the bytes it moves are the
    fetched planes once."""
    w = tmm.pack_weights_kmajor(torch.randn(64, 24))
    seen = {}

    def record(x, planes, ids, rnd):
        seen.update(planes=planes, ids=list(ids))
        return torch.zeros(x.shape[0], planes.shape[2])

    monkeypatch.setattr(tmm, "elastic_matmul_planes", record)
    ops.elastic_matmul(torch.zeros(2, 64, dtype=torch.bfloat16), w, r_m, d_m)
    P = 9 + min(r_m + d_m, 7)
    assert seen["ids"] == list(range(16 - P, 16))
    assert seen["planes"].data_ptr() == w[16 - P].data_ptr()
    assert seen["planes"].untyped_storage().data_ptr() == \
        w.untyped_storage().data_ptr()


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(4)
    jq, q = _bf16(rng, (2, 8, 32))
    jk, k = _bf16(rng, (2, 40, 2, 32))
    jv, v = _bf16(rng, (2, 40, 2, 32))
    got = ops.decode_attention(q, k, v, 29)
    want = np.asarray(rref.decode_attention_ref(jq, jk, jv, 29))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("bad", [
    lambda: ops.bitplane_pack(torch.zeros((4, 12), dtype=torch.int16)),
    lambda: ops.elastic_unpack(torch.zeros((8, 4, 2), dtype=torch.uint8)),
    lambda: ops.elastic_matmul(torch.zeros((2, 16), dtype=torch.bfloat16),
                               torch.zeros((16, 3, 4), dtype=torch.uint8)),
    lambda: ops.elastic_matmul(torch.zeros((2, 16), dtype=torch.float32),
                               torch.zeros((16, 2, 4), dtype=torch.uint8)),
])
def test_bad_inputs_raise(bad):
    with pytest.raises((TypeError, ValueError)):
        bad()
