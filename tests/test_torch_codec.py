"""Port vs reference: LZ4 prep (kernel's plain version), match events
(numpy twin and the PyTorch device pipeline on the CPU), frames, the slab
codec entry point, bypass pre-screen and hardened decompression — byte
identity throughout, on the reference's adversarial and fuzz corpora.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_lz4_kernel import _adversarial_corpus, _fuzz_corpus  # noqa: E402

from repro.core import codec as rcodec  # noqa: E402
from repro.kernels import lz4 as rlz4  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lz4 as tlz4  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _slabs():
    rng = np.random.default_rng(5)
    parts = [
        np.zeros(300, np.uint8),
        rng.integers(0, 256, 300, dtype=np.uint8),
        np.tile(np.arange(4, dtype=np.uint8), 100),
        rng.integers(0, 3, 300, dtype=np.uint8),
    ]
    yield parts
    yield [np.frombuffer(c, dtype=np.uint8) for c in _adversarial_corpus()]
    # a packed-plane-like slab: long zero runs, sparse noise, periodic rows
    planes = [np.where(rng.random(1024) < p, rng.integers(0, 256, 1024), 0)
              .astype(np.uint8) for p in (0.0, 0.01, 0.2, 0.9)]
    yield planes + [np.tile(rng.integers(0, 256, 13).astype(np.uint8), 80)]


def _bounds(parts):
    sizes = np.asarray([p.size for p in parts], dtype=np.int64)
    ends = np.cumsum(sizes)
    return np.concatenate(parts) if parts else np.empty(0, np.uint8), \
        ends - sizes, ends


def _pallas_prep_span(n):
    """Positions the reference's prep grid computes: its padding leaves
    ``n + pad - 3`` short of a row multiple, so the last partial tile
    (everything past 32640 bytes per 32768-byte tile) is never written."""
    tile = rlz4._PREP_BLOCK * rlz4._PREP_C
    rows = (n + (-n - 3) % tile) // rlz4._PREP_C
    br = min(rlz4._PREP_BLOCK, rows)
    return min(n, rows // br * br * rlz4._PREP_C)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 777, 32640, 70000])
def test_plain_prep_matches_pallas(n):
    buf = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    w, h, runb = tlz4.prep_plain(torch.from_numpy(buf))
    rw, rh, rrun = rlz4._prep_pallas(jnp.asarray(buf), interpret=True)
    m = _pallas_prep_span(n)
    np.testing.assert_array_equal(w.numpy().view(np.uint32)[:m],
                                  np.asarray(rw)[:m])
    np.testing.assert_array_equal(h.numpy()[:m], np.asarray(rh)[:m])
    # runb past N-1 compares against the pad and is never read
    np.testing.assert_array_equal(runb.numpy()[: min(m, n - 1)],
                                  np.asarray(rrun)[: min(m, n - 1)])
    # everywhere, the plain prep is the reference's numpy word/hash pass
    if n >= 4:
        rw_np, rh_np = rlz4._words_hashes(buf)
        np.testing.assert_array_equal(w.numpy().view(np.uint32)[: n - 3], rw_np)
        np.testing.assert_array_equal(h.numpy()[: n - 3], rh_np)
    before = build.LAUNCHES["lz4_prep"]
    w2, _, _ = tlz4.lz4_prep(torch.from_numpy(buf))
    assert build.LAUNCHES["lz4_prep"] == before
    assert torch.equal(w2, w)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_match_events_identical_to_reference(which):
    parts = list(_slabs())[which]
    buf, starts, ends = _bounds(parts)
    ref_np = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    ref_dev = rlz4.match_events_slab(buf, starts, ends, force="device")
    twin = tlz4.match_events_slab(buf, starts, ends, force="numpy")
    dev = tlz4.match_events_slab(torch.from_numpy(buf.copy()), starts, ends,
                                 force="device")
    for r, rd, t, d in zip(ref_np, ref_dev, twin, dev):
        np.testing.assert_array_equal(r, rd)
        np.testing.assert_array_equal(t, r)
        np.testing.assert_array_equal(d, r)
        assert t.dtype == d.dtype == np.int64


def test_device_pipeline_matches_numpy_twin_past_one_prep_tile():
    """A main-path-sized slab (17 plane streams, 69632 bytes): the port's
    device pipeline selects the numpy twin's events at every position,
    including past the first 32640 bytes."""
    rng = np.random.default_rng(0)
    parts = [np.where(rng.random(4096) < 0.3, rng.integers(0, 256, 4096), 0)
             .astype(np.uint8) for _ in range(17)]
    buf, starts, ends = _bounds(parts)
    ref = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    dev = tlz4.match_events_slab(torch.from_numpy(buf), starts, ends,
                                 force="device")
    for r, d in zip(ref, dev):
        np.testing.assert_array_equal(r, d)


def test_match_events_gapped_slab_on_device_pipeline():
    """Streams with gaps (bypassed ranges) between them: the device
    pipeline never matches across or into a gap."""
    rng = np.random.default_rng(3)
    a = np.zeros(256, np.uint8)
    gap = rng.integers(0, 256, 64, dtype=np.uint8)
    b = rng.integers(0, 4, 256, dtype=np.uint8)
    buf = np.concatenate([a, gap, b])
    starts, ends = np.array([0, 320]), np.array([256, 576])
    ref = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    dev = tlz4.match_events_slab(torch.from_numpy(buf), starts, ends,
                                 force="device")
    for r, d in zip(ref, dev):
        np.testing.assert_array_equal(r, d)


@pytest.mark.parametrize("force", [None, "device"])
def test_frames_identical_to_reference(force):
    chunks = _adversarial_corpus() + [p.tobytes() for p in list(_slabs())[2]]
    ref = rcodec.lz4_compress_batch(chunks)
    assert tcodec.lz4_compress_batch(chunks, force=force) == ref
    assert [tcodec.lz4_compress(c) for c in chunks] == ref
    for data, comp in zip(chunks, ref):
        if data:
            assert tcodec.lz4_decompress(comp, max_out=len(data)) == data


def test_scalar_oracle_env_gives_identical_frames(monkeypatch):
    chunks = _adversarial_corpus()
    ref = rcodec.lz4_compress_batch(chunks)
    monkeypatch.setenv("TRACE_SCALAR_LZ4", "1")
    assert tcodec._scalar_lz4_forced()
    assert tcodec.lz4_compress_batch(chunks) == ref


@pytest.mark.parametrize("codec", ["lz4", "none"])
def test_compress_slab_and_batch_identical(codec):
    """Slab entry point on a CPU tensor (with bypassed incompressible
    streams leaving gaps) and the chunk batch entry point."""
    parts = list(_slabs())[2] + [
        np.random.default_rng(8).integers(0, 256, 2048, dtype=np.uint8)]
    buf, starts, ends = _bounds(parts)
    ref = rcodec.compress_slab(buf, starts, ends, codec)
    got = tcodec.compress_slab(torch.from_numpy(buf.copy()), starts, ends,
                               codec)
    assert got == ref
    assert rcodec.RAW in ref[1]              # the noise stream bypassed
    chunks = [p.tobytes() for p in parts]
    assert tcodec.compress_batch(chunks, codec) == \
        rcodec.compress_batch(chunks, codec)
    for c in chunks:
        assert tcodec.prescreen_bypass(c) == rcodec.prescreen_bypass(c)
    dec = tcodec.decompress_batch(got[0], got[1], codec,
                                  [len(c) for c in chunks])
    assert dec == chunks


def test_decompress_fuzz_raises_corrupt_payload_error():
    """Truncated and bit-flipped frames raise CorruptPayloadError (a
    ValueError) or decode within bounds — exactly as the reference."""
    assert issubclass(tcodec.CorruptPayloadError, ValueError)
    for data in _fuzz_corpus():
        comp = tcodec.lz4_compress(data)
        stride = max(1, len(comp) // 64)
        cases = [comp[:cut] for cut in range(0, len(comp), stride)]
        for i in range(0, len(comp), stride):
            bad = bytearray(comp)
            bad[i] ^= 0x80
            cases.append(bytes(bad))
        for frame in cases:
            try:
                ref = rcodec.lz4_decompress(frame, max_out=len(data))
            except rcodec.CorruptPayloadError:
                with pytest.raises(tcodec.CorruptPayloadError):
                    tcodec.lz4_decompress(frame, max_out=len(data))
                continue
            assert tcodec.lz4_decompress(frame, max_out=len(data)) == ref
    with pytest.raises(tcodec.CorruptPayloadError):
        tcodec.lz4_decompress(b"\x04\x00\x00")
    with pytest.raises(tcodec.CorruptPayloadError):
        tcodec.lz4_decompress(b"\x14A\x05\x00")
