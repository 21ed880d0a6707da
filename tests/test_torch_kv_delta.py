"""Port vs reference: the cross-token KV exponent-delta transform
(``kernels.kv_delta``), forward and inverse, byte identity throughout.

The forward and inverse plain versions (which the wrappers take for CPU
tensors) against the reference's Pallas kernels in interpret mode
(``repro.kernels.ops.kv_transform`` / ``kv_transform_inv``), its jnp
oracles and the numpy chain ``repro.core.kv_transform``; the modal beta
with ties to the smallest exponent; any beta round-tripping with
specials; and the inverse's view round against ``reconstruct_u16`` of
the exact inverse, for every view the tier produces; the windows of
``tests/torch_kv_score_cases.py`` (many-way ties, all-distinct channels,
n across a token group and past the kernel's 256-token tile, C from 1
to 1024) byte-identical to the numpy batch.  The CUDA kernels themselves
run only on the card (``tests/test_torch_kernels_gpu.py``), on the same
windows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kv_transform as rkv  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import kv_delta as tkv  # noqa: E402
import torch_kv_score_cases as cases  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SPECIALS = np.array([0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 0x7F81, 0x8000, 0x0000,
                     0x0001, 0x807F, 0x7F7F, 0x407F], dtype=np.uint16)


def _t(u16):
    return torch.from_numpy(np.ascontiguousarray(u16).view(np.int16).copy())


def _u(t):
    return t.numpy().view(np.uint16)


def _with_specials(u, seed):
    rng = np.random.default_rng(seed)
    u = u.copy()
    flat = u.reshape(-1)
    idx = rng.integers(0, flat.size, max(flat.size // 32, 1))
    flat[idx] = rng.choice(SPECIALS, idx.size)
    return u


@pytest.mark.parametrize("n,C", [(64, 128), (256, 256), (16, 512), (17, 128)])
def test_forward_matches_pallas_oracle_and_numpy(n, C):
    kv = synth.kv_cache(n, C, seed=5)
    stream, meta = rkv.kv_forward(kv)
    before = build.LAUNCHES["kv_delta_fwd"]
    out, beta = tkv.kv_forward(_t(kv)[None])
    assert build.LAUNCHES["kv_delta_fwd"] == before      # CPU: plain version
    np.testing.assert_array_equal(beta[0].numpy(), meta.beta)
    np.testing.assert_array_equal(_u(out[0]).ravel(), stream)
    jb = jnp.asarray(meta.beta)
    np.testing.assert_array_equal(
        _u(out[0]), np.asarray(rops.kv_transform(jnp.asarray(kv), jb)))
    np.testing.assert_array_equal(
        _u(out[0]), np.asarray(rref.kv_delta_ref(jnp.asarray(kv), jb)))
    back = tkv.kv_inverse(out, beta)
    np.testing.assert_array_equal(_u(back[0]), kv)
    np.testing.assert_array_equal(
        _u(back[0]), np.asarray(rops.kv_transform_inv(
            jnp.asarray(_u(out[0])), jb)))


@pytest.mark.parametrize("B,n,C", [(3, 64, 128), (2, 17, 128), (4, 5, 24)])
def test_batch_matches_numpy_batch(B, n, C):
    rng = np.random.default_rng(B * n + C)
    w = ((rng.standard_normal((B, n, C))
          * np.exp(rng.uniform(-4, 4, (1, 1, C)))).astype(np.float32)
         .view(np.uint32) >> 16).astype(np.uint16)
    w = _with_specials(w, C)
    streams, metas = rkv.kv_forward_batch(w)
    out, beta = tkv.kv_forward(_t(w))
    np.testing.assert_array_equal(_u(out).reshape(B, -1), streams)
    np.testing.assert_array_equal(beta.numpy(), np.stack([m.beta
                                                          for m in metas]))
    np.testing.assert_array_equal(_u(tkv.kv_inverse(out, beta)),
                                  rkv.kv_inverse_batch(streams, metas))


@pytest.mark.parametrize("B,n,C", cases.KV_SHAPES_CPU)
def test_forward_edge_windows_match_numpy_batch(B, n, C):
    """The card tests' windows: the plain forward byte-identical to
    ``kv_forward_batch`` (modal beta, ties to the smallest exponent), and
    window 0 with that beta to the Pallas kernel (the jnp oracle where
    its channel block does not divide C)."""
    w = cases.kv_case(B, n, C, seed=B * n + C)
    streams, metas = rkv.kv_forward_batch(w)
    out, beta = tkv.kv_forward(_t(w))
    want_beta = np.stack([m.beta for m in metas])
    np.testing.assert_array_equal(beta.numpy(), want_beta)
    np.testing.assert_array_equal(_u(out).reshape(B, -1), streams)
    if n >= 4:
        assert int(beta[0, 0]) == cases.tie_winner(n)
    if C >= 3 and n >= 2:
        assert int(beta[0, 2]) == 0                  # 0 and 255 tie
    jb = jnp.asarray(want_beta[0].astype(np.int32))
    # the Pallas kernel takes C a multiple of its 128-channel block (or
    # less); the jnp oracle any C
    twin = rops.kv_transform if C % min(128, C) == 0 else rref.kv_delta_ref
    np.testing.assert_array_equal(
        _u(out[0]), np.asarray(twin(jnp.asarray(w[0]), jb)))
    given, _ = tkv.kv_forward(_t(w), beta)
    assert torch.equal(given, out)


def test_modal_beta_ties_go_to_the_smallest_exponent():
    w = np.zeros((2, 6, 4), np.uint16)
    w[0, :, 0] = [0x4000, 0x3F80, 0x4000, 0x3F80, 0x4100, 0x4100]  # 3-way
    w[0, :, 1] = [0x7F80, 0x0000, 0xFFC0, 0x8001, 0x3F80, 0x3F81]  # 255 vs 0
    w[0, :, 2] = 0x3F80                                            # no tie
    w[0, :, 3] = [0x0001, 0x7F80, 0x3F80, 0x4000, 0x4080, 0x4100]  # all 1s
    w[1] = w[0, ::-1]
    _, metas = rkv.kv_forward_batch(w)
    want = np.stack([m.beta for m in metas])
    np.testing.assert_array_equal(want[0], [127, 0, 127, 0])
    np.testing.assert_array_equal(tkv.modal_beta_plain(_t(w)).numpy(), want)
    np.testing.assert_array_equal(tkv.kv_forward(_t(w))[1].numpy(), want)


@pytest.mark.parametrize("n,C", [(64, 128), (17, 40)])
def test_arbitrary_beta_roundtrips_with_specials(n, C):
    rng = np.random.default_rng(7)
    kv = rng.integers(0, 1 << 16, (n, C)).astype(np.uint16)
    kv = _with_specials(kv, n)
    beta = rng.integers(0, 256, C).astype(np.uint8)
    out, got_beta = tkv.kv_forward(_t(kv)[None], torch.from_numpy(beta)[None])
    assert torch.equal(got_beta[0], torch.from_numpy(beta))
    jb = jnp.asarray(beta.astype(np.int32))
    np.testing.assert_array_equal(
        _u(out[0]), np.asarray(rops.kv_transform(jnp.asarray(kv), jb)))
    back = tkv.kv_inverse(out, torch.from_numpy(beta)[None])
    np.testing.assert_array_equal(_u(back[0]), kv)


VIEW_NAMES = ["bf16", "man4", "man2", "man0", "score", "cut11", "cut9e"]


def _views(mod, name):
    if name == "score":
        return mod.SCORE
    if name == "cut11":     # MAN4-truncated block read at (r_m 2, d_m 4)
        return mod.PrecisionView(r_m=2, d_m=3, name="cut11")
    if name == "cut9e":     # fewer exponent planes: mask only, no round
        return mod.PrecisionView(r_e=6, r_m=2, d_m=1, name="cut9e")
    return mod.VIEWS[name]


@pytest.mark.parametrize("name", VIEW_NAMES)
def test_inverse_round_matches_reconstruct(name):
    """Inverse + view round == ``reconstruct_u16`` of the exact inverse of
    the streams masked to the view's planes, in both packages — the order
    the tier's read path runs them in."""
    tview, rview = _views(tprec, name), _views(rprec, name)
    kv = _with_specials(synth.kv_cache(64, 128, seed=3), 3)
    kv[::9, 7] = 0x407F          # MAN4's round carries into the exponent
    kv[::11, 8] = 0x7F7F         # and saturates at the Inf pattern
    kv[::13, 9] = 0x7F81         # NaN whose payload is in dropped planes
    stream, meta = rkv.kv_forward(kv)
    mask = np.uint16(tview.plane_mask())
    fetched = stream & mask
    want = rprec.reconstruct_u16(
        rkv.kv_inverse(fetched, meta).ravel(), rview).reshape(kv.shape)
    got = tkv.kv_inverse(_t(fetched.reshape(128, 64))[None],
                         torch.from_numpy(meta.beta)[None], tview)
    np.testing.assert_array_equal(_u(got[0]), want)


@pytest.mark.parametrize("bad", [
    lambda: tkv.kv_forward(torch.zeros((4, 8), dtype=torch.int16)),
    lambda: tkv.kv_forward(torch.zeros((1, 4, 8), dtype=torch.float32)),
    lambda: tkv.kv_forward(torch.zeros((1, 4, 8), dtype=torch.int16),
                           torch.zeros((1, 4), dtype=torch.uint8)),
    lambda: tkv.kv_inverse(torch.zeros((1, 8, 4), dtype=torch.int16),
                           torch.zeros((1, 8), dtype=torch.int32)),
])
def test_wrappers_reject_bad_inputs(bad):
    with pytest.raises((TypeError, ValueError)):
        bad()
