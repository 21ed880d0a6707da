"""Port vs reference: the partial-attention algebra that the decode
attention kernel's sequence split carries.

``attention_partial`` and ``combine_partials`` of
``repro_torch.kernels.decode_attn`` against the reference's numpy pair
(``repro.kernels.decode_attn``), and the split itself — partials cut at
the kernel's block boundaries (``split_size``, multiples of
``SPLIT_POSITIONS``) and merged — against ``decode_attention_plain`` and
the Pallas kernel in interpret mode; likewise the split that the
device-length entry's blocks compute on the card from the length over
the capacity's fixed grid (``device_split``, ``grid_splits``).  Inputs
are made from a numpy seed and handed to both packages bit for bit.

Tolerance: f32, atol 2e-5 and rtol 1e-5 — the versions sum the same
products in other orders (per chunk, then merged).
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attn as rattn  # noqa: E402
from repro_torch.kernels import decode_attn as tattn  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5
DTYPES = {"bf16": (ml_dtypes.bfloat16, torch.bfloat16),
          "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, KV, hd, S, kv, seed):
    """q bf16 and a K/V cache in ``kv`` as numpy (ml_dtypes) arrays and as
    tensors holding the same bits."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    ndt, tdt = DTYPES[kv]
    nq = q.astype(ml_dtypes.bfloat16)
    nk, nv = (a.astype(ml_dtypes.bfloat16).astype(ndt) for a in (k, v))

    def tensor(a, dt):
        width = np.int16 if a.itemsize == 2 else np.uint8
        return torch.from_numpy(a.view(width).copy()).view(dt)

    return (nq, nk, nv), (tensor(nq, torch.bfloat16), tensor(nk, tdt),
                          tensor(nv, tdt))


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("H,KV", [(4, 4), (14, 2), (16, 1)],
                         ids=["group1", "group7", "group16"])
@pytest.mark.parametrize("valid", [None, 45], ids=["full", "masked"])
def test_partial_and_combine_match_reference(kv, H, KV, valid):
    (nq, nk, nv), (tq, tk, tv) = _inputs(2, H, KV, 64, 96, kv,
                                         seed=H * 7 + KV)
    cuts = [(0, 40), (40, 41), (41, 96)]
    ref_parts = [rattn.attention_partial(nq, nk[:, a:b], nv[:, a:b],
                                         None if valid is None else valid - a)
                 for a, b in cuts]
    parts = [tattn.attention_partial(tq, tk[:, a:b], tv[:, a:b],
                                     None if valid is None else valid - a)
             for a, b in cuts]
    for (m, l, acc), (rm, rl, racc) in zip(parts, ref_parts):
        np.testing.assert_allclose(m.numpy(), rm, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(l.numpy(), rl, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(acc.numpy(), racc, atol=ATOL, rtol=RTOL)
    got = tattn.combine_partials(parts).numpy()
    np.testing.assert_allclose(got, rattn.combine_partials(ref_parts),
                               atol=ATOL, rtol=RTOL)
    full = tattn.decode_attention_plain(tq, tk, tv, 96 if valid is None
                                        else valid).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)
    assert got.dtype == np.float32 and got.shape == (2, H, 64)


def _split_attention(q, k, v, valid):
    """Partials over the kernel's blocks of ``split_size`` positions below
    ``valid``, merged."""
    B, _, KV, _ = k.shape
    chunk = tattn.split_size(valid, B * KV, H100_SMS)
    return tattn.combine_partials([
        tattn.attention_partial(q, k[:, a:min(a + chunk, valid)],
                                v[:, a:min(a + chunk, valid)])
        for a in range(0, valid, chunk)])


P = tattn.SPLIT_POSITIONS
H100_SMS = 132


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("valid", [1, P - 1, P, P + 1, 2 * P - 1, 2 * P,
                                   2 * P + 1, 576])
def test_split_matches_plain_and_pallas(kv, valid):
    """qwen2-0.5b's decode shape, q (1, 14, 64) over a (1, 640, 2, 64)
    cache: one block, a block boundary +-1 and the main path's 576."""
    (nq, nk, nv), (tq, tk, tv) = _inputs(1, 14, 2, 64, 640, kv, seed=valid)
    got = _split_attention(tq, tk, tv, valid).numpy()
    plain = tattn.decode_attention_plain(tq, tk, tv, valid).numpy()
    pallas = np.asarray(rattn.decode_attention_pallas(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), valid,
        block_s=128, interpret=True))
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("valid", [2048, 2049])
def test_split_where_the_merge_leaves_the_cluster(valid):
    """At most 16 blocks of up to 4 tiles merge on chip; one more position
    and the blocks (33 of two tiles) merge through device memory."""
    (nq, nk, nv), (tq, tk, tv) = _inputs(1, 14, 2, 64, 2560, "bf16",
                                         seed=valid)
    got = _split_attention(tq, tk, tv, valid).numpy()
    pallas = np.asarray(rattn.decode_attention_pallas(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), valid,
        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_split_of_many_rows_and_long_context():
    """A larger grid takes larger blocks (multiples of SPLIT_POSITIONS,
    none past valid_len); the merge still matches the Pallas kernel."""
    valid = 2000
    (nq, nk, nv), (tq, tk, tv) = _inputs(2, 16, 8, 32, 2048, "bf16", seed=5)
    chunk = tattn.split_size(valid, 2 * 8, H100_SMS)
    assert chunk > P and chunk % P == 0
    got = _split_attention(tq, tk, tv, valid).numpy()
    pallas = np.asarray(rattn.decode_attention_pallas(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), valid,
        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("valid,rows,chunk", [
    (1, 1, P), (P, 1, P), (P + 1, 1, P),
    (16 * P, 2, P),               # 16 blocks of one tile: one cluster
    (16 * P + 1, 2, 2 * P),
    (576, 2, 2 * P),              # main path: 9 blocks of 2 tiles
    (2048, 2, 4 * P),             # the longest context a cluster merges
    (2049, 2, 2 * P),             # merged through device memory: 33 blocks
    (4096, 2, 3 * P),             # 43 blocks
    (8192, 2, 6 * P),             # 43 blocks: longer blocks, not more
    (12288, 2, 8 * P),            # 48 blocks of MERGE_TILES
    (12289, 2, 7 * P),            # longer: 55 blocks
    (32768, 2, 16 * P),           # 64 blocks, MAX_SPLITS
    (32768, 64, 249 * P),         # many rows: ~2 blocks per SM
])
def test_split_size(valid, rows, chunk):
    got = tattn.split_size(valid, rows, H100_SMS)
    assert got == chunk and got % P == 0
    n_split = -(-valid // got)
    assert n_split <= tattn.MAX_SPLITS
    if n_split > tattn.MERGE_SPLITS:    # MERGE_SPLITS blocks: too long
        tiles = -(-valid // P)
        assert -(-tiles // tattn.MERGE_SPLITS) > tattn.MERGE_TILES
    assert (n_split - 1) * got < valid                # no empty block
    if n_split > tattn.CLUSTER_SPLITS:
        assert rows * n_split <= max(tattn.BLOCKS_PER_SM * H100_SMS, rows)


# -- the device-length entry's split, computed on the card from the length


def _device_split_attention(q, k, v, valid, capacity):
    """Partials over the blocks of the split the device-length entry's
    grid computes from ``valid`` (``device_split``), merged; blocks past
    the active ones hold nothing and are not merged."""
    B, _, KV, _ = k.shape
    active, chunk = tattn.device_split(valid, capacity, B * KV, H100_SMS)
    grid = tattn.grid_splits(capacity, B * KV, H100_SMS)
    assert 1 <= active <= grid
    cuts = [(s * chunk, min((s + 1) * chunk, valid)) for s in range(active)]
    assert all(a < b for a, b in cuts) and cuts[-1][1] == valid
    return tattn.combine_partials([
        tattn.attention_partial(q, k[:, a:b], v[:, a:b]) for a, b in cuts])


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("capacity,valid", [
    (640, 1), (640, 31), (640, 32), (640, 33), (640, 576),
    (2560, 1), (2560, 31), (2560, 32), (2560, 33), (2560, 576),
    (2560, 2017), (2560, 2048), (2560, 2049)])
def test_device_split_matches_reference_and_pallas(kv, capacity, valid):
    """The split at the main path's shape, q (1, 14, 64) over a (1,
    capacity, 2, 64) cache: the port's partials merged against the
    reference's ``attention_partial`` / ``combine_partials`` at the same
    cuts, and against the Pallas kernel (interpret mode) over the whole
    cache."""
    (nq, nk, nv), (tq, tk, tv) = _inputs(1, 14, 2, 64, capacity, kv,
                                         seed=capacity + valid)
    got = _device_split_attention(tq, tk, tv, valid, capacity).numpy()
    active, chunk = tattn.device_split(valid, capacity, 2, H100_SMS)
    ref = rattn.combine_partials([
        rattn.attention_partial(nq, nk[:, a:min(a + chunk, valid)],
                                nv[:, a:min(a + chunk, valid)])
        for a in range(0, active * chunk, chunk)])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    pallas = np.asarray(rattn.decode_attention_pallas(
        jnp.asarray(nq), jnp.asarray(nk), jnp.asarray(nv), valid,
        block_s=128 if capacity % 512 else 512, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("valid", [2017, 32768])
def test_device_split_of_a_long_cache(valid):
    """A 32768-slot cache at narrow width (q (1, 2, 32) over (1, 32768,
    1, 32)): the device split at a short length and at the capacity held
    to the plain version and to the reference's numpy pair."""
    S = 32768
    (nq, nk, nv), (tq, tk, tv) = _inputs(1, 2, 1, 32, S, "bf16", seed=valid)
    got = _device_split_attention(tq, tk, tv, valid, S).numpy()
    plain = tattn.decode_attention_plain(tq, tk, tv, valid).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)
    active, chunk = tattn.device_split(valid, S, 1, H100_SMS)
    ref = rattn.combine_partials([
        rattn.attention_partial(nq, nk[:, a:min(a + chunk, valid)],
                                nv[:, a:min(a + chunk, valid)])
        for a in range(0, active * chunk, chunk)])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("capacity,rows,hd", [
    (640, 2, 64), (640, 16, 64), (32768, 2, 64), (32768, 16, 64),
    (640, 2, 128), (640, 16, 128)])
def test_device_split_never_longer_than_the_host_split(capacity, rows, hd):
    """At every length in [1, capacity], on the grid the wrapper launches
    (``devlen_grid``, 7 query heads a KV head): no block of the device
    split takes more tiles than ``split_size`` gives a block, except where
    that grid has fewer blocks a row than the split needs.  That happens
    only for wide blocks (hd 128 x 8 heads: the rule spreads a context of
    2048 positions or fewer over WIDE_CLUSTER blocks, and at 640 slots
    that is the whole grid), at the lengths whose host split wants more
    than 8 blocks; there the tiles spread evenly over the grid.  Every
    length's split fits the grid, and some length fills it."""
    cluster = tattn.block_cluster(hd, 7)
    grid = tattn.devlen_grid(capacity, rows, H100_SMS, hd, 7)
    assert grid == tattn.grid_splits(capacity, rows, H100_SMS, cluster)
    assert grid <= tattn.MAX_SPLITS
    wide = hd * 8 >= tattn.WIDE_BLOCK
    assert cluster == (tattn.WIDE_CLUSTER if wide else tattn.CLUSTER_SPLITS)
    spread = 0
    for valid in range(1, capacity + 1):
        host = tattn.split_size(valid, rows, H100_SMS)
        need = -(-valid // host)
        active, chunk = tattn.device_split(valid, capacity, rows, H100_SMS,
                                           cluster)
        if need <= grid:
            assert chunk == host and active == need
        else:                       # fewer blocks than the split needs
            spread += 1
            assert wide and chunk > host and active <= grid
            assert chunk == P * -(-(-(-valid // P)) // grid)
        assert (active - 1) * chunk < valid <= active * chunk
    assert spread == 0 or wide
    assert max(tattn.device_split(n, capacity, rows, H100_SMS, cluster)[0]
               for n in range(1, capacity + 1)) == grid


@pytest.mark.parametrize("valid,cluster,active,chunk", [
    (32768, 16, 17, 2016),      # the capacity: 17 blocks through memory
    (2017, 16, 16, 128),        # a short context: 16 blocks of 4 tiles
    (576, 16, 9, 64),           # [main]'s position: 9 blocks of 2 tiles
    (576, 8, 6, 96),            # wide blocks: 8 at most, 6 of 3 tiles
    (2048, 8, 8, 256),          # wide blocks up to 2048 positions
    (2049, 8, 17, 128),         # past 2048: the rule's memory split
    (0, 16, 1, 32), (40000, 16, 17, 2016),   # clamped to [1, capacity]
])
def test_device_split_values(valid, cluster, active, chunk):
    """The device split at q (8, 14, 64) over a 32768-slot cache (16
    rows): short contexts over ``cluster`` blocks, longer ones by the
    merge rule; lengths are clamped to [1, capacity]."""
    assert tattn.device_split(valid, 32768, 16, H100_SMS, cluster) == \
        (active, chunk)


@pytest.mark.parametrize("capacity,rows,hd,group,grid", [
    (640, 2, 64, 7, 16),         # qwen2-0.5b: 16-block clusters
    (640, 8, 128, 7, 8),         # llava-next-34b: wide blocks, 8 at most
    (640, 2, 64, 16, 8),         # 16 heads x hd 64: wide
    (2560, 2, 128, 7, 40),       # merged through memory: the rule's grid
    (32768, 16, 64, 7, 17),
])
def test_devlen_grid(capacity, rows, hd, group, grid):
    """The wrapper's grid for a device length: the rule's (``grid_splits``
    with ``block_cluster``: at most WIDE_CLUSTER blocks for a short
    context of wide blocks); every length spread over it, none past it."""
    got = tattn.devlen_grid(capacity, rows, H100_SMS, hd, group)
    assert got == grid
    cluster = tattn.block_cluster(hd, group)
    for valid in range(1, capacity + 1, 7):
        active, chunk = tattn.device_split(valid, capacity, rows, H100_SMS,
                                           cluster)
        assert active <= got and (active - 1) * chunk < valid <= \
            active * chunk and chunk % P == 0
