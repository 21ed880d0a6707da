"""Port vs reference: the LZ4 greedy match of an encode slab.

``match_plain`` — the PyTorch pipeline the card's ``lz4_match.cu`` is held
against — must select the reference's events on every case of
``torch_lz4_cases``: the reference's device pipeline (Pallas prep in
interpret mode, then the jitted match rounds) and both numpy twins.  The
reference's prep leaves the positions past the last whole 32768-byte
tile of its grid unwritten, so its device pipeline runs on the slab with
one zero tile appended (a gap no stream covers), and on the slab as given
where the slab fits in one tile.  Also the wrapper's host side: event
rows, their compaction without a sort, and the launch's set-up
(``match_launch``) against a host stand-in for the library.
"""

import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_lz4_cases import cases  # noqa: E402

from repro.core import codec as rcodec  # noqa: E402
from repro.kernels import lz4 as rlz4  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lz4 as tlz4  # noqa: E402

PREP_TILE = rlz4._PREP_BLOCK * rlz4._PREP_C
NAMES = ["kv_slab", "kv_slab_prescreened", "lengths", "gapped",
         "periodic_3900", "long_65537", "far_repeat", "hash_collision",
         "runs", "next_stream"]


@pytest.fixture(scope="module")
def slabs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield cases()
    torch.set_num_threads(n)


def _assert_events(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_cases_cover_the_names(slabs):
    assert sorted(slabs) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_match_plain_identical_to_reference(slabs, name):
    buf, starts, ends = slabs[name]
    ref = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    padded = np.concatenate([buf, np.zeros(PREP_TILE, np.uint8)])
    _assert_events(
        tuple(np.asarray(a, np.int64) for a in rlz4.match_events_slab(
            padded, starts, ends, force="device")), ref)
    if buf.size + 3 <= PREP_TILE:
        _assert_events(tuple(np.asarray(a, np.int64) for a in
                             rlz4.match_events_slab(buf, starts, ends,
                                                    force="device")), ref)
    _assert_events(tlz4.match_events_slab(buf, starts, ends, force="numpy"),
                   ref)
    before = dict(build.LAUNCHES)
    _assert_events(tlz4.match_plain(torch.from_numpy(buf.copy()), starts,
                                    ends), ref)
    _assert_events(tlz4.match_events_slab(torch.from_numpy(buf.copy()),
                                          starts, ends, force="device"), ref)
    assert build.LAUNCHES == before     # a CPU tensor launches nothing


def test_cases_hit_the_rules(slabs):
    """The special cases select what they were built for."""
    pos, dist, mlen = rlz4.match_events_slab(*slabs["far_repeat"],
                                             force="numpy")
    assert 65535 in dist and not (dist > 0xFFFF).any()
    assert not ((dist > 1000) & (dist < 65535)).any()
    buf, starts, ends = slabs["hash_collision"]
    pos, dist, mlen = rlz4.match_events_slab(buf, starts, ends,
                                             force="numpy")
    assert (pos >= starts[1]).all() and pos.size > 0
    pos, dist, _ = rlz4.match_events_slab(*slabs["runs"], force="numpy")
    assert (dist == 1).any()
    buf, starts, ends = slabs["next_stream"]
    pos, _, _ = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    per = np.bincount(np.searchsorted(ends, pos, side="right"),
                      minlength=starts.size)
    assert per[0] >= 1 and per[1] >= 1


def test_event_rows():
    starts = np.array([0, 0, 10, 20, 100])
    ends = np.array([0, 10, 13, 37, 1124])
    np.testing.assert_array_equal(tlz4.event_rows(starts, ends),
                                  [0, 1, 4, 4 + 1, 5 + 5, 10 + 257])


def test_compact_events_keeps_used_rows_in_stream_order():
    rows = np.array([0, 3, 4, 8])
    ev = np.full((3, 8), -1, np.int32)
    ev[:, 0:2] = [[5, 9], [1, 2], [4, 6]]
    ev[:, 4:7] = [[20, 30, 40], [3, 4, 5], [7, 8, 9]]
    got = tlz4.compact_events(ev, np.array([2, 0, 3]), rows)
    _assert_events(got, (np.array([5, 9, 20, 30, 40]),
                         np.array([1, 2, 3, 4, 5]),
                         np.array([4, 6, 7, 8, 9])))


@pytest.mark.parametrize("name", ["kv_slab_prescreened", "lengths",
                                  "gapped"])
def test_plain_rows_compact_to_sorted_events(slabs, name):
    """The plain pipeline's rows and counts, compacted with no sort, are
    the numpy twin's events; positions rise throughout."""
    buf, starts, ends = slabs[name]
    ev, count = tlz4.match_rows_plain(torch.from_numpy(buf.copy()), starts,
                                      ends)
    rows = tlz4.event_rows(starts, ends)
    assert ev.shape == (3, rows[-1]) and count.shape == starts.shape
    assert (count.numpy() <= np.diff(rows)).all()
    got = tlz4.compact_events(ev.numpy(), count.numpy(), rows)
    assert (np.diff(got[0]) > 0).all()
    _assert_events(got, tlz4.match_events_slab(buf, starts, ends,
                                               force="numpy"))


class _HostMatchLib:
    """The match library's C interface on the host, for the launch's set-up:
    records the arguments and fills the output with the plain pipeline's
    rows and counts, read through the pointers as the kernel would."""

    def __init__(self, tile_max: int, rows_counts):
        self.tile_max, self.rows_counts = tile_max, rows_counts
        self.args = None

    def lz4_match_tile_max(self):
        return self.tile_max

    def lz4_match_table_bytes(self):
        return 131584

    def lz4_match(self, w, h, meta, S, tile, scratch, out, E, device,
                  stream):
        self.args = dict(tile=tile, E=E, meta=np.ctypeslib.as_array(
            (ctypes.c_int64 * (4 * S)).from_address(meta)).reshape(4, S)
            .copy())
        ev, count = self.rows_counts
        dst = np.ctypeslib.as_array((ctypes.c_int32 * (S + 3 * E))
                                    .from_address(out))
        dst[:S], dst[S:] = count.numpy(), ev.numpy().ravel()
        return 0


@pytest.mark.parametrize("name", ["kv_slab_prescreened", "lengths",
                                  "gapped", "long_65537"])
def test_match_launch_lays_out_meta_rows_and_scratch(slabs, name,
                                                     monkeypatch):
    """The launch set-up shared by the wrapper and the chip scripts: one
    meta column per stream (start, end, first event row, scratch offset,
    -1 for a stream staged in shared memory), the tile rounded up to 128
    over the staged streams, and the scratch of longer streams back to
    back; its output read back as the numpy twin's events."""
    buf, starts, ends = slabs[name]
    slab = torch.from_numpy(buf.copy())
    lib = _HostMatchLib(256, tlz4.match_rows_plain(slab, starts, ends))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    launch, out, rows = tlz4.match_launch(slab, starts, ends, lib=lib)
    launch()
    sizes = ends - starts
    long = sizes > 256
    lp = -(-sizes[long] // 128) * 128
    scr = 131584 + 28 * lp + lp // 4
    soff = np.full(starts.size, -1)
    soff[long] = np.cumsum(scr) - scr
    np.testing.assert_array_equal(lib.args["meta"],
                                  [starts, ends, rows[:-1], soff])
    assert lib.args["E"] == rows[-1]
    assert lib.args["tile"] == (-(-sizes[~long].max() // 128) * 128
                                if (~long).any() else 0)
    _assert_events(tlz4.match_result(out, rows),
                   tlz4.match_events_slab(buf, starts, ends, force="numpy"))


def test_match_launch_checks_bounds_before_building():
    slab = torch.zeros(100, dtype=torch.uint8)
    for starts, ends in (([0, 40], [50, 90]), ([10], [5]), ([0], [101]),
                         ([0, 1], [1])):
        with pytest.raises(ValueError):
            tlz4.match_launch(slab, np.array(starts), np.array(ends))
    with pytest.raises(ValueError):
        tlz4.match_launch(torch.zeros(200, dtype=torch.uint8)[::2],
                          np.array([0]), np.array([100]))
    launch, _, rows = tlz4.match_launch(slab, np.array([], int),
                                        np.array([], int))
    assert launch is None and rows.tolist() == [0]


def test_lz4_match_rejects_what_it_cannot_take(slabs):
    buf, starts, ends = slabs["gapped"]
    with pytest.raises(TypeError):
        tlz4.lz4_match(torch.from_numpy(buf.astype(np.int16)), starts, ends)
    with pytest.raises(TypeError):
        tlz4.lz4_match(torch.from_numpy(buf).reshape(1, -1), starts, ends)


def test_compress_slab_frames_identical_on_the_plain_pipeline(slabs):
    buf, starts, ends = slabs["kv_slab"]
    want = rcodec.compress_slab(buf, starts, ends, "lz4")
    got = tcodec.compress_slab(torch.from_numpy(buf.copy()), starts, ends,
                               "lz4", force="device")
    assert got == want
