"""Port vs reference: the tier's fused KV read
(``kernels.bitplane.unpack_kv_windows``: unpack → exponent-delta inverse
→ round, one launch per group of same-shape windows on the card), bit
identity throughout.

On CPU tensors the wrapper takes its plain version; it is held to the
reference's numpy chain (``unpack_planes_subset`` → ``kv_inverse_batch``
→ ``reconstruct_u16``) and to its Pallas kernels in interpret mode (the
unrounded unpack, then ``kv_delta_inv_pallas``, then the view's round),
at every view the tier reads KV with, on full and partial windows whose
members lie apart in the rows, in any order.  The CUDA kernel itself
runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitplane as rbit  # noqa: E402
from repro.core import kv_transform as rkv  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro.kernels import bitplane as rkbit  # noqa: E402
from repro.kernels import kv_delta as rkkv  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
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


# every view the tier reads KV with: the policy views, the PNM score view
# and a truncated block's intersection (a MAN4 block read at r_m 2, d_m 4)
VIEWS = ["bf16", "man4", "man2", "man0", "score", "cut11"]
# (B, n, C): a decode slab's 8 full windows, then partial flushes whose
# channel boundaries fall inside bytes (n not a multiple of 8), and an
# odd channel count whose windows end inside a byte
SHAPES = [(8, 64, 128), (1, 17, 128), (2, 33, 40), (3, 37, 40), (2, 7, 5)]


def _views(name):
    if name == "score":
        return tprec.SCORE, rprec.SCORE
    if name == "cut11":
        return (tprec.PrecisionView(r_m=2, d_m=3, name="cut11"),
                rprec.PrecisionView(r_m=2, d_m=3, name="cut11"))
    return tprec.VIEWS[name], rprec.VIEWS[name]


def _patterns(shape, seed):
    """bf16 patterns of KV-like magnitudes (per-channel scales) with every
    special the round treats apart: NaN with its payload only in low
    planes, +-Inf, a round that carries into the exponent and one that
    saturates at Inf."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, shape[-1])))
    u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    flat = u.reshape(-1)
    for k, pat in enumerate((0x7F81, 0xFF80, 0x7F80, 0x407F, 0x7F7F,
                             0xFFC1)):
        flat[k :: 97 - 6 * k] = pat
    return u


def _slab(B, n, C, seed):
    """``B`` windows transformed as the tier stores them, packed into one
    slab of plane rows with random bytes before, between and after them
    (members apart), listed in shuffled order: (windows in member order,
    their metas, member starts in elements, the slab's 16 plane rows)."""
    rng = np.random.default_rng(seed)
    windows = _patterns((B, n, C), seed)
    streams, metas = rkv.kv_forward_batch(windows)
    # one member stored against an arbitrary beta: the inverse is exact
    # for any
    arb = rng.integers(0, 256, C, dtype=np.uint8)
    streams[0] = np.asarray(rkv.kv_forward_jnp(jnp.asarray(windows[0]),
                                               jnp.asarray(arb))).ravel()
    metas[0] = rkv.KVBlockMeta(beta=arb, n_tokens=n, n_channels=C)
    L = n * C
    segs, starts, pos = [], [], 0
    for b in range(B):
        gap = 8 * int(rng.integers(1, 5))
        pad = -L % 8                      # a window ends inside a byte
        segs += [rng.integers(0, 1 << 16, gap, dtype=np.uint16), streams[b],
                 rng.integers(0, 1 << 16, pad, dtype=np.uint16)]
        starts.append(pos + gap)
        pos += gap + L + pad
    segs.append(rng.integers(0, 1 << 16, 24, dtype=np.uint16))
    planes = rbit.pack_planes(np.concatenate(segs))
    order = rng.permutation(B)
    return (windows[order], [metas[i] for i in order],
            [starts[i] for i in order], planes)


def _port(planes, idx, starts, metas, tview):
    rows = torch.from_numpy(np.ascontiguousarray(planes[list(idx)]))
    beta = torch.from_numpy(np.stack([m.beta for m in metas]))
    n, C = metas[0].n_tokens, metas[0].n_channels
    before = dict(build.LAUNCHES)
    got = tkbit.unpack_kv_windows(rows, idx, starts, n, C, beta, tview)
    assert build.LAUNCHES == before       # CPU tensors: the plain version
    assert got.dtype == torch.int16 and got.shape == (len(starts), n, C)
    return got.numpy().view(np.uint16)


@pytest.mark.parametrize("B,n,C", SHAPES)
@pytest.mark.parametrize("name", VIEWS)
def test_kv_read_matches_reference_chain(name, B, n, C):
    tview, rview = _views(name)
    windows, metas, starts, planes = _slab(B, n, C, n * C + B)
    idx = rview.fetched_planes()
    rows = np.ascontiguousarray(planes[list(idx)])
    L = n * C
    fetched = np.stack([rbit.unpack_planes_subset(
        rows[:, s // 8 : (s + L + 7) // 8], idx, L) for s in starts])
    want = rprec.reconstruct_u16(rkv.kv_inverse_batch(fetched, metas), rview)
    np.testing.assert_array_equal(_port(planes, idx, starts, metas, tview),
                                  want)
    if name == "bf16":
        np.testing.assert_array_equal(want, windows)


@pytest.mark.parametrize("B,n,C", SHAPES)
@pytest.mark.parametrize("name", VIEWS)
def test_kv_read_matches_pallas_kernels(name, B, n, C):
    """The reference's two TPU kernels in interpret mode, one window at a
    time: the unpack over the zeroed 16-plane stack with every fetched bit
    kept, the exponent-delta inverse, then the view's round."""
    tview, rview = _views(name)
    _, metas, starts, planes = _slab(B, n, C, n * C + 2 * B)
    idx = rview.fetched_planes()
    L, nb = n * C, -(-n * C // 8)
    want = []
    for s, m in zip(starts, metas):
        stack = np.zeros((16, nb), dtype=np.uint8)
        stack[list(idx)] = planes[list(idx), s // 8 : s // 8 + nb]
        words = rkbit.unpack_planes_pallas(jnp.asarray(stack[:, None, :]),
                                           interpret=True)
        cm = np.asarray(words).ravel()[:L].reshape(C, n)
        tok = rkkv.kv_delta_inv_pallas(jnp.asarray(cm), jnp.asarray(m.beta),
                                       interpret=True)
        want.append(rprec.reconstruct_u16(np.asarray(tok), rview))
    np.testing.assert_array_equal(_port(planes, idx, starts, metas, tview),
                                  np.stack(want))


@pytest.mark.parametrize("starts,beta_shape", [
    ([4], (1, 8)),            # not a byte
    ([-8], (1, 8)),           # before the rows
    ([72], (1, 8)),           # runs past the rows' end
    ([0], (2, 8)),            # beta for another member count
])
def test_kv_read_rejects_windows_it_cannot_read(starts, beta_shape):
    rows = torch.zeros((9, 16), dtype=torch.uint8)     # 128 elements
    beta = torch.zeros(beta_shape, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tkbit.unpack_kv_windows(rows, tuple(range(15, 6, -1)), starts, 8, 8,
                                beta, tprec.SCORE)


@pytest.mark.parametrize("name", VIEWS[:-1])
def test_tier_reads_scattered_groups_like_the_reference(name):
    """One readback slab holding KV groups of two shapes, interleaved, and
    a tensor: each group's members lie apart in the slab's rows, and the
    port's tier returns the reference tier's words at every view."""
    kv = synth.kv_cache(64 * 3 + 17, 128, seed=5)
    out = []
    for mod, pmod in ((ttier, tprec), (rtier, rprec)):
        kw = {"device": "cpu"} if mod is ttier else {}
        dev = mod.TierStore("bitplane-kv", kv_window=64, **kw)
        W, R = mod.WriteReq, mod.ReadReq
        dev.submit([W("p0", kv[:64], kind=mod.KV),
                    W("part", kv[192:209], kind=mod.KV),
                    W("w", synth.weights(1000, seed=6)),
                    W("p1", kv[64:192], kind=mod.KV)])
        view = _views(name)[pmod is rprec]
        out.append(dev.submit([R(k, kind=kind, view=view)
                               for k, kind in (("p1", mod.KV),
                                               ("part", mod.KV),
                                               ("w", mod.TENSOR),
                                               ("p0", mod.KV))]))
    for a, b in zip(*out, strict=True):
        np.testing.assert_array_equal(a.data, b.data)
