"""Port vs reference: the LZ4 greedy match of an encode slab.

``match_plain`` — the PyTorch pipeline the card's ``lz4_match.cu`` is held
against — must select the reference's events on every case of
``torch_lz4_cases``: the reference's device pipeline (Pallas prep in
interpret mode, then the jitted match rounds) and both numpy twins.  The
reference's prep leaves the positions past the last whole 32768-byte
tile of its grid unwritten, so its device pipeline runs on the slab with
one zero tile appended (a gap no stream covers), and on the slab as given
where the slab fits in one tile.  ``match_chain_plain`` — the kernel's
own selection rule (chain-end lengths, next candidates by rank, the
greedy chain by pointer doubling) in PyTorch operations — must select
the same events on every case.  Also the wrapper's host side: event
rows, their compaction without a sort, and the launch's set-up
(``match_plan``, ``match_launch``) against a host stand-in for the
library.
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
NAMES = ["kv_slab", "kv_slab_prescreened", "weight_slab", "lengths",
         "gapped",
         "periodic_3900", "long_65537", "far_repeat", "hash_collision",
         "runs", "next_stream", "runs_over_cap", "long_matches", "far_next",
         "broken_chain", "single_and_short"]


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


@pytest.mark.parametrize("name", NAMES)
def test_match_chain_plain_identical_to_reference(slabs, name):
    """The kernel's selection rule, event for event, against the JAX
    reference's match_events_slab and the port's plain pipeline."""
    buf, starts, ends = slabs[name]
    ref = rlz4.match_events_slab(buf, starts, ends, force="numpy")
    slab = torch.from_numpy(buf.copy())
    before = dict(build.LAUNCHES)
    got = tlz4.match_chain_plain(slab, starts, ends)
    _assert_events(got, ref)
    _assert_events(got, tlz4.match_plain(slab, starts, ends))
    assert build.LAUNCHES == before


def _local_events(slabs, name):
    buf, starts, ends = slabs[name]
    pos, dist, mlen = rlz4.match_events_slab(buf, starts, ends,
                                             force="numpy")
    sid = np.searchsorted(ends, pos, side="right")
    return sid, pos - starts[sid], dist, mlen, ends[sid] - 5 - pos


def test_selection_cases_hit_their_rules(slabs):
    """The generated streams reach what they were built for: run matches
    at the length cap and one byte short of it, matches of 35-37 bytes
    and longer than 8 words, next candidates more than 2 mask words on,
    a chain of same-distance candidates broken inside a match, one
    candidate in a stream, none in streams shorter than MFLIMIT + 1."""
    _, _, dist, mlen, cap = _local_events(slabs, "runs_over_cap")
    assert (dist == 1).all() and (mlen == cap).any() \
        and (mlen == cap - 1).any()
    _, _, _, mlen, _ = _local_events(slabs, "long_matches")
    assert {35, 36, 37}.issubset(set(mlen.tolist())) and (mlen > 36).sum() > 3
    _, lq, _, _, _ = _local_events(slabs, "far_next")
    assert lq.size >= 3 and (np.diff(lq) > 64).all()
    buf, starts, ends = slabs["broken_chain"]
    _, lq, dist, mlen, _ = _local_events(slabs, "broken_chain")
    assert (lq[0], dist[0], mlen[0]) == (100, 100, 80)
    w = buf[starts[0] + 140: starts[0] + 144]
    assert not np.array_equal(w, buf[starts[0] + 88: starts[0] + 92]) and \
        tlz4._words_hashes(buf[starts[0] + 88: starts[0] + 92])[1][0] == \
        tlz4._words_hashes(w)[1][0]
    sid, _, _, _, _ = _local_events(slabs, "single_and_short")
    _, starts, ends = slabs["single_and_short"]
    assert sid.tolist() == [0] and ((ends - starts)[1:] <= 13).all()


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

    def __init__(self, tile_max: int, pack: int, rows_counts):
        self.tile_max, self.pack, self.rows_counts = tile_max, pack, rows_counts
        self.args = None

    def lz4_match_tile_max(self):
        return self.tile_max

    def lz4_match_pack_bytes(self):
        return self.pack

    def lz4_match_scratch_bytes(self, P):
        return 131152 + 12304 * (P // 512)

    def lz4_match(self, buf, meta, S, B, tile, scratch, out, E, device,
                  stream):
        self.args = dict(buf=buf, S=S, B=B, tile=tile, E=E,
                         meta=np.ctypeslib.as_array(
                             (ctypes.c_int64 * (5 * S + B + 1))
                             .from_address(meta)).copy())
        ev, count = self.rows_counts
        dst = np.ctypeslib.as_array((ctypes.c_int32 * (S + 3 * E))
                                    .from_address(out))
        dst[:S], dst[S:] = count.numpy(), ev.numpy().ravel()
        return 0


def _check_plan(meta, B, tile, starts, ends, addr, pack, tile_max,
                scratch_bytes):
    """The layout's invariants: the meta's columns; blocks of consecutive
    streams, each stream's region on a 32-position word with its first
    byte at its address mod 16, regions disjoint inside the tile, at most
    pack / 32 streams a block; a stream of more than pack region bytes
    alone, one past tile_max in scratch, back to back."""
    S = starts.size
    rows = tlz4.event_rows(starts, ends)
    assert meta.shape == (5 * S + B + 1,)
    st, en, rw, soff, cst = meta[: 5 * S].reshape(5, S)
    first = meta[5 * S:]
    np.testing.assert_array_equal(st, starts)
    np.testing.assert_array_equal(en, ends)
    np.testing.assert_array_equal(rw, rows[:-1])
    assert first[0] == 0 and first[-1] == S and (np.diff(first) > 0).all()
    assert tile % 128 == 0 and tile <= tile_max
    off = (addr + starts) & 15
    rsz = np.maximum((off + ends - starts + 31) // 32 * 32, 32)
    assert ((cst & 15) == off).all()
    at = 0
    for b in range(B):
        s0, s1 = first[b], first[b + 1]
        base = cst[s0:s1] - off[s0:s1]
        assert base[0] == 0 and (base % 32 == 0).all()
        assert (base[1:] >= base[:-1] + rsz[s0:s1 - 1]).all()
        assert s1 - s0 <= pack // 32
        if s1 - s0 > 1:
            assert (rsz[s0:s1] <= pack).all()
        span = base[-1] + rsz[s1 - 1]
        if span > tile_max:
            assert s1 - s0 == 1 and soff[s0] == at
            at += scratch_bytes(-(-span // 512) * 512)
        else:
            assert (soff[s0:s1] == -1).all() and span <= tile
    return at


@pytest.mark.parametrize("name", ["kv_slab_prescreened", "lengths",
                                  "gapped", "long_65537"])
def test_match_launch_lays_out_meta_rows_and_scratch(slabs, name,
                                                     monkeypatch):
    """The launch set-up shared by the wrapper and the chip scripts: the
    meta (starts, ends, first event rows, scratch offsets, block-local
    first positions, each block's first stream) as ``_check_plan`` holds
    it, the slab's bytes handed over with no prep, and its output read
    back as the numpy twin's events."""
    buf, starts, ends = slabs[name]
    slab = torch.from_numpy(buf.copy())
    lib = _HostMatchLib(512, 128, tlz4.match_rows_plain(slab, starts, ends))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    before = dict(build.LAUNCHES)
    launch, out, rows = tlz4.match_launch(slab, starts, ends, lib=lib)
    launch()
    assert build.LAUNCHES == before     # no prep, and launch() counts none
    args = lib.args
    assert args["buf"] == slab.data_ptr() and args["S"] == starts.size
    assert args["E"] == rows[-1]
    _check_plan(args["meta"], args["B"], args["tile"], starts, ends,
                slab.data_ptr(), 128, 512, lib.lz4_match_scratch_bytes)
    _assert_events(tlz4.match_result(out, rows),
                   tlz4.match_events_slab(buf, starts, ends, force="numpy"))


@pytest.mark.parametrize("name", ["kv_slab_prescreened", "gapped"])
def test_match_launch_keeps_its_plan_for_repeated_bounds(slabs, name,
                                                          monkeypatch):
    """A repeat of the same bounds at the same address mod 16 reuses the
    uploaded meta and the rows; other bounds, or another address mod 16,
    get a layout of their own; the library keeps at most ``PLANS_KEPT``,
    the oldest going first."""
    buf, starts, ends = slabs[name]
    assert starts.size >= 3
    raw = torch.from_numpy(np.concatenate([np.zeros(16, np.uint8), buf]))
    views = [raw[k : k + buf.size] for k in (0, 1)]   # addresses differ
    lib = _HostMatchLib(512, 128, tlz4.match_rows_plain(
        torch.from_numpy(buf.copy()), starts, ends))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tlz4, "PLANS_KEPT", 3)
    want = tlz4.match_events_slab(buf, starts, ends, force="numpy")

    def run(view):
        launch, out, rows = tlz4.match_launch(view, starts, ends, lib=lib)
        launch()
        assert not rows.flags.writeable
        _check_plan(lib.args["meta"], lib.args["B"], lib.args["tile"],
                    starts, ends, view.data_ptr(), 128, 512,
                    lib.lz4_match_scratch_bytes)
        _assert_events(tlz4.match_result(out, rows), want)
        return rows

    rows = run(views[0])
    assert run(views[0]) is rows and len(lib._match_plans) == 1
    assert run(views[1]) is not rows and len(lib._match_plans) == 2
    tlz4.match_launch(views[0], starts[:-1], ends[:-1], lib=lib)
    assert len(lib._match_plans) == 3
    tlz4.match_launch(views[0], starts[1:], ends[1:], lib=lib)
    assert len(lib._match_plans) == 3            # the first plan went
    assert run(views[0]) is not rows


@pytest.mark.parametrize("addr", [0, 1, 5, 8, 15])
@pytest.mark.parametrize("name", ["kv_slab_prescreened", "lengths",
                                  "gapped", "long_65537", "runs_over_cap",
                                  "single_and_short"])
@pytest.mark.parametrize("geometry", [(512, 7552), (128, 512)])
def test_match_plan_packs_streams_into_blocks(slabs, name, addr, geometry):
    """The layout at every address mod 16 and two library geometries (the
    card's pack and tile, and a small one that sends long streams to
    scratch): its invariants hold, and streams of up to ``pack`` region
    bytes share blocks."""
    buf, starts, ends = slabs[name]
    pack, tile_max = geometry
    lib = _HostMatchLib(tile_max, pack, None)
    meta, B, tile, nscr = tlz4.match_plan(starts, ends, addr, pack, tile_max,
                                          lib.lz4_match_scratch_bytes)
    assert _check_plan(meta, B, tile, starts, ends, addr, pack, tile_max,
                       lib.lz4_match_scratch_bytes) == nscr
    # a region is at most size + 47 bytes: of three consecutive streams of
    # up to pack / 2 region bytes, two start in one pack window
    fits = (ends - starts) + 47 <= pack // 2
    if (fits[:-2] & fits[1:-1] & fits[2:]).any():
        assert B < starts.size
    big = (ends - starts) + 47 > pack
    assert B <= 2 * big.sum() + 1 + -(-((ends - starts)[~big] + 47).sum()
                                      // pack)


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
