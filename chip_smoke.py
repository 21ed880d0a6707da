"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it — pack, prep, page scoring, the KV
   exponent-delta forward and inverse, the bit-plane unpack and the
   fused KV read (unpack → inverse → round in one launch) bit-equal
   (page scoring also on ragged, empty, NaN and inf pages, on duplicate
   pages and on one page alone and inside a larger batch; the KV and
   unpack kernels at every view the tier reads with, on histogram ties,
   Inf, NaN, carries and saturation, and an arbitrary beta round trip;
   the fused read also on partial windows whose members lie apart),
   decode attention (at split boundaries, bit-equal across two calls)
   and the elastic matmul (at every view, P = 9..16 planes) within f32
   tolerance; the LZ4 match kernel event for event against the plain
   pipeline on the card and the numpy twin (a flush slab built as the
   tier builds it, with the pre-screen's gaps; a gapped slab; a periodic
   stream; streams past 65536 bytes at the 0xFFFF window) — and time
   kernel, plain version and the one PyTorch call computing the same
   function where there is one (SDPA under each backend that takes the
   shape, the fastest reported; torch.matmul at M = 1 and 16), after the
   floor of one launch (a 16-byte ``zero_()``); the pack at the flush slab
   and at a 896 x 4864 weight and the prep over each one's planes with and
   without run flags, page scoring at 2048 pages and the KV forward at
   2048 windows (long context) — each checked too, and timed back to back
   and from a cold L2 cache; decode
   attention at 4096 and 32768 cached positions, the elastic matmul at
   each view beside its byte bound, the fused KV read beside the
   two-launch chain it replaces, and the match launch beside the wrapper
   (prep + match + one copy back) and the plain pipeline it replaces;
3. drive the kernel API (``repro_torch.kernels.ops``), the only path
   that reaches the elastic matmul and the standalone KV inverse, with
   the launch counts set to 0 just before and read just after;
4. check the card's tier against the CPU's on the same KV pages: writes,
   readback at every view (policy views, the score view, a truncated
   block's intersection, a partial window, a tensor) and PNM gathers
   (receipts, scores, winners and bytes identical); the per-block encoder
   (``batched_encode=False``) on the card against the batched one and
   the CPU's, with a pack launch per block and a prep and a match launch
   per block with a plane stream the pre-screen keeps; a
   full-width KV pool (24 layers, K and V, 64-token pages) whose
   ``prefetch_layer`` + ``read_layer`` equals a plain ``read_layer``,
   words and stats; and the card's model against the CPU's on a small
   input;
5. serve 3 requests (512 prompt + 64 new tokens) through full-width
   qwen2-0.5b with random weights, KV spilling to a ``trace`` tier, with
   the kernel launch counts set to 0 just before and read just after
   (the KV read goes through the fused kernel alone: the standalone
   inverse must not launch; every flush launches the prep, without run
   flags, and the match kernel once each);
   then ``kv_through_tier`` of every layer's K and V and ``layer_traffic``
   of one more such request equal a CPU pool's fed its page stream;
6. the weight stream at full width (``[weights]``): the 168 decoder
   matrices of qwen2-0.5b (24 layers x wq, wk, wv, wo, w1, w3, w2 at
   their real shapes, importance falling with the layer) loaded by one
   ``WeightStore.put_many`` into a ``trace`` tier on the card (a pack,
   a prep without run flags and a match launch per 128 Ki-element encode
   slab) and read back by one ``fetch_all`` at the ``DEFAULT_TIERS``
   views (a standalone unpack + round launch per 64 Ki-element decode
   slab; no KV kernel, no matmul): every unit equal to
   ``view_round_plain`` of its source's fetched planes, FULL units the
   params bit for bit; the same units on a ``plain`` device for the DRAM
   read ratio; layer 0 through a CPU tier, bytes, flags and receipts
   equal; the standalone unpack held to its plain version and timed at
   a weight's decode slab at each view (its own row in the ``kernels``
   line, apart from the fused KV read's ``bitplane_unpack``); the
   first 4 layers on a 4-shard ``replicate-weights`` fleet (words and
   per-shard bytes the single device's, async reads spread over the
   replicas) and one request of 512 + 64 tokens served on that fleet
   (tokens equal one device's);
7. the PNM path at full width, one request per case, launch counts read
   per case: (a) classic readback, (b) a gather covering every candidate
   (tokens identical to a), (c) top-16 gathers with attention importance
   (fewer link bytes than a), (d) c on a 4-shard fleet (tokens identical
   to c), with the page-scoring wrapper's wall time per gather;
8. continuous batching at full width (``[sched]``): six requests of
   512 + 64 tokens sharing their first 256, Poisson arrivals at 0.5 a
   decode round, through ``ServeScheduler`` (3 slots, a KV capacity of
   1.5 projections under the physical model) in four cases, launch
   counts read per case: (a) prefix share — tokens equal solo runs,
   shared pages a follower acquired read back at FULL bit-identical to
   its own cache windows, queue delay and an admission discount; (b) a
   with the reclaim ladder — 0 B reclaimed, every spilled page being a
   shared prompt page; (c) the ladder without share — bytes reclaimed;
   (d) c on 4 shards — c's tokens and bytes; the tier empty after each;
   wall tok/s and per-request wall latency from a synchronizing host
   clock around every ``step()``, beside the modeled report;
9. two streams through ``MultiStreamEngine`` (``[streams]``), each
   stream's tokens equal to its solo run;
10. the three example twins (``repro_torch.examples``: quickstart,
   serve_async, serve_continuous) on the card, as run without ``--cpu``:
   their own assertions, the tier kernels launched, the quickstart's
   numbers equal to its CPU run;
11. profile one more classic request (host split from cProfile, device
   busy time from ``torch.profiler``) and one PNM request (cProfile).

Prints the card's name and power limit, a ``kernels`` JSON line, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_S = 67e12          # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS_S = 989e12        # H100 SXM dense bf16 tensor-core rate
ATOL, RTOL = 2e-5, 1e-5      # f32 summation-order tolerance (attention)
# Elastic matmul: bf16 x bf16 products are exact in f32, so kernel and
# plain version (a full-f32 cuBLAS product, TF32 off) differ only in the
# order of the f32 sum over K: the reference's own test tolerance.
MM_ATOL = MM_RTOL = 1e-5
# Page scoring: kernel and plain version sum each dot in the same order
# and round each product once, so they agree bit for bit (tolerance 0).
# The KV transform and the unpack are integer bit work: tolerance 0.

# Main-path shapes: full-width qwen2-0.5b, 64-token pages, 512 + 64 tokens.
SLAB_ELEMS = 128 * 1024      # BitplaneLayout.ENCODE_SLAB_ELEMS
DECODE_ELEMS = 64 * 1024     # BitplaneLayout.SLAB_ELEMS: one decode slab
FLUSH_WINDOWS = 128          # KV windows of the prefill flush: 128 of
                             # the 384 prompt pages spill (PERF.md §4)
WINDOW = 64                  # kv_window (tokens) = the page
D_MODEL, D_FF = 896, 4864    # the MLP up-projection of qwen2-0.5b
HEADS, KV_HEADS, HEAD_DIM = 14, 2, 64
MAX_SEQ, VALID_LEN = 512 + 64 + 64, 576
PAGES, PAGE_ROWS = 64, 64    # gather candidates per KV kind at prefill
# long context (128 k tokens): the pages a gather scores per layer and
# kind, the windows of a flush
LONG_PAGES = LONG_WINDOWS = 2048
PACK_LONG = D_MODEL * D_FF   # a weight's pack: the MLP up-projection
CHANNELS = KV_HEADS * HEAD_DIM
VOCAB = 151936


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; inputs stay resident in L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20):
    """Device time per call of ``fn``: the summed time of every CUDA kernel
    it launched, from ``torch.profiler`` (CUPTI), or None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    return total_us / 1e3 / iters if total_us > 0 else None


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def timed(torch, fn, iters: int = 50) -> dict:
    """``ms``: device time per call (profiler; CUDA events when the
    profiler sees no device work); ``call_ms``: CUDA-event time per call
    of back-to-back calls, which includes the host's launch cadence."""
    call = time_ms(torch, fn, iters, min(5, iters))
    dev = device_ms(torch, fn, min(20, iters))
    return {"ms": call if dev is None else dev, "call_ms": call,
            "ms_from": "events" if dev is None else "profiler"}


def cold_ms(torch, fn, kernel: str, iters: int = 10):
    """Device time per call of the kernels of ``fn`` whose name holds
    ``kernel``, each call after a 128 MiB write has pushed its inputs out
    of the 50 MB L2 cache (profiler; None when it sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 25, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if kernel in e.key)
    return us / 1e3 / iters if us > 0 else None


def warm_cold_line(torch, what: str, kernel: str, fn, plain,
                   nbytes: float, flops: float) -> dict:
    """Time a kernel (back to back, inputs in L2 where they fit, and from a
    cold L2) beside its plain version and its bound, and print it.
    Returns :func:`timed`'s keys with ``cold_ms``, ``plain_ms``,
    ``bound_ms`` and ``bound_by``."""
    warm = timed(torch, fn, 20)
    cold = cold_ms(torch, fn, kernel)
    b, by = bound_ms(nbytes, flops)
    plain_ms = timed(torch, plain, 5)["ms"]
    cold_s = "not measured" if cold is None else \
        f"{cold * 1e3:.2f} us ({100 * b / cold:.1f}% of the bound)"
    print(f"[kernel] {what}: {warm['ms'] * 1e3:.2f} us device back to back "
          f"({warm['ms_from']}; {100 * b / warm['ms']:.1f}% of the bound), "
          f"cold L2 {cold_s}; bound {b * 1e3:.3f} us by {by}; plain "
          f"{plain_ms * 1e3:.2f} us", flush=True)
    return dict(**warm, cold_ms=cold, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS_S) -> tuple:
    """The least time for the work: bytes over the memory rate or
    operations over ``peak``, whichever is larger, and which."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kv_like(torch, n: int, gen) -> "torch.Tensor":
    """bf16 bit patterns shaped like KV activations, with NaN/Inf/zeros."""
    x = (torch.randn(n, generator=gen, device="cuda") * 0.8).to(torch.bfloat16)
    x[::997] = float("nan")
    x[1::1499] = float("inf")
    x[2::31] = 0.0
    return x.view(torch.int16)


def same_scores(torch, a, b) -> bool:
    """Bitwise equal, NaN matching NaN (payloads may differ)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan], b[~nan]))


def check_pnm_score(torch, k_pnm, results):
    """Page scoring at the main path's shapes and its edge cases."""
    import numpy as np

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((PAGES, PAGE_ROWS, CHANNELS)) * 0.7)
    u = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    digest = torch.from_numpy(
        rng.standard_normal(CHANNELS).astype(np.float32)).cuda()
    full = torch.full((PAGES,), PAGE_ROWS, dtype=torch.int32, device="cuda")
    ragged = torch.from_numpy(
        rng.integers(1, PAGE_ROWS + 1, PAGES).astype(np.int32)).cuda()
    ragged[0] = 0                          # an empty page scores -inf
    ragged[1:3] = PAGE_ROWS
    odd = u.copy()
    odd[1, 0, 0] = 0x7FC0                  # NaN in a valid row
    odd[2, 5, 7] = 0x7F80                  # +inf in a valid row
    odd[3, PAGE_ROWS - 1, 3] = 0x7FC0      # NaN, in a row past valid below
    ragged[3] = PAGE_ROWS - 1
    odd[5] = odd[4]                        # byte-identical pages
    ragged[5] = ragged[4]
    pages = torch.from_numpy(u.view(np.int16)).cuda()
    odd_pages = torch.from_numpy(odd.view(np.int16)).cuda()
    for pg, valid in ((pages, full), (pages, ragged), (odd_pages, ragged)):
        got = k_pnm.page_scores(pg, valid, digest)
        want = k_pnm.page_scores_plain(pg, valid, digest)
        torch.cuda.synchronize()
        if not same_scores(torch, got, want):
            raise AssertionError("pnm_score differs from its plain version")
    if not (float(got[0]) == float("-inf") and bool(torch.isnan(got[1]))
            and bool(torch.isfinite(got[3])) and float(got[4]) == float(got[5])):
        raise AssertionError(f"pnm_score edge cases wrong: {got[:6]}")
    # one page alone and inside a larger batch padded to another T
    pages_np = [odd[i, : int(ragged[i])] for i in range(8)]
    d_np = digest.cpu().numpy()
    batch = k_pnm.page_scores_u16(
        pages_np + [np.zeros((200, CHANNELS), np.uint16)], d_np, "cuda")[:-1]
    alone = np.array([k_pnm.page_scores_u16([p], d_np, "cuda")[0]
                      for p in pages_np])
    if batch.tobytes() != alone.tobytes():
        raise AssertionError("pnm_score depends on the batch a page is in")
    b, by = bound_ms(score_bytes(PAGES), 2 * PAGES * PAGE_ROWS * CHANNELS)
    results["pnm_score"] = dict(
        name="pnm_score", route="cuda", source="src/repro_torch/csrc/pnm_score.cu",
        replaces="src/repro/kernels/pnm_score.py:66", max_abs_err=0.0,
        **timed(torch, lambda: k_pnm.page_scores(pages, full, digest)),
        plain_ms=timed(torch, lambda: k_pnm.page_scores_plain(
            pages, full, digest))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)

    # long context: a 128 k-token gather scores 2048 pages a layer and kind
    x = rng.standard_normal((LONG_PAGES, PAGE_ROWS, CHANNELS),
                            dtype=np.float32) * 0.7
    u = (x.view(np.uint32) >> 16).astype(np.uint16)
    u[7, 3, 5] = 0x7FC0                    # NaN in a valid row
    u[9, PAGE_ROWS - 1, 0] = 0x7FC0        # NaN past valid below
    big = torch.from_numpy(u.view(np.int16)).cuda()
    vbig = torch.full((LONG_PAGES,), PAGE_ROWS, dtype=torch.int32,
                      device="cuda")
    full_long = vbig.clone()
    vbig[9] = PAGE_ROWS - 1
    got = k_pnm.page_scores(big, vbig, digest)
    if not (same_scores(torch, got, k_pnm.page_scores_plain(big, vbig, digest))
            and bool(torch.isnan(got[7])) and bool(torch.isfinite(got[9]))):
        raise AssertionError("pnm_score at 2048 pages differs from its "
                             "plain version")
    warm_cold_line(
        torch, f"pnm_score long context ({LONG_PAGES} x {PAGE_ROWS} x "
        f"{CHANNELS})", "pnm_score_kernel",
        lambda: k_pnm.page_scores(big, full_long, digest),
        lambda: k_pnm.page_scores_plain(big, full_long, digest),
        score_bytes(LONG_PAGES), 2 * LONG_PAGES * PAGE_ROWS * CHANNELS)


def score_bytes(pages: int) -> int:
    """Bytes page scoring must move: every row, the digest, and per page
    its valid count and its score."""
    return pages * PAGE_ROWS * CHANNELS * 2 + CHANNELS * 4 + pages * 8


def kv_windows(torch, B: int, n: int, seed: int) -> "torch.Tensor":
    """(B, n, CHANNELS) bf16 patterns shaped like a layer's K or V pages
    (per-channel scales), with the edges the KV kernels treat apart:
    histogram ties (window 0, channel 0: two exponents equally often),
    +-Inf, NaN whose payload lies only in low mantissa planes, a value
    whose MAN4 round carries into the exponent and one that saturates at
    Inf."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, n, CHANNELS)) * np.exp(
        rng.uniform(-3, 3, CHANNELS))
    u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    flat = u.reshape(-1)
    for k, pat in enumerate((0x7F81, 0xFF80, 0x7F80, 0x407F, 0x7F7F,
                             0xFFC1)):
        flat[k::97 - 4 * k] = pat
    if n >= 2:
        u[0, : n // 2, 0] = 0x3F80
        u[0, n // 2 : 2 * (n // 2), 0] = 0x4000
    return torch.from_numpy(u.view(np.int16)).cuda()


def read_views():
    """Every view the tier reads KV with: the policy views, the PNM score
    view and a truncated block's intersection (a MAN4 block read at
    r_m 2, d_m 4 is served at cut11)."""
    from repro_torch.core import precision as prec

    return [prec.FULL, prec.MAN4, prec.MAN2, prec.MAN0, prec.SCORE,
            prec.PrecisionView(r_m=2, d_m=3, name="cut11")]


def check_kv_and_unpack(torch, build, k_bitplane, k_kv, results):
    """The write path's forward on one prefill flush and on partial
    windows, then the read path on one decode slab at every view: the
    standalone unpack (every fetched bit kept, and rounded), the
    standalone inverse + round, and the fused read the tier launches, also
    over partial windows apart in a slab."""
    import numpy as np

    # -- forward: one prefill flush, partial windows, ties, given beta -------
    x = kv_windows(torch, FLUSH_WINDOWS, WINDOW, 3)
    for win in (x, kv_windows(torch, 3, 37, 4), kv_windows(torch, 1, 17, 5)):
        got, beta = k_kv.kv_forward(win)
        want, want_beta = k_kv.kv_forward_plain(win)
        torch.cuda.synchronize()
        if not (torch.equal(beta, want_beta) and torch.equal(got, want)):
            raise AssertionError(f"kv_delta_fwd {tuple(win.shape)} differs "
                                 "from its plain version")
        if int(beta[0, 0]) != 127:
            raise AssertionError(f"histogram tie went to {int(beta[0, 0])}, "
                                 "not the smaller exponent 127")
    arb = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (FLUSH_WINDOWS, CHANNELS), dtype=np.uint8)).cuda()
    cm_arb, _ = k_kv.kv_forward(x, arb)
    if not (torch.equal(cm_arb, k_kv.kv_forward_plain(x, arb)[0])
            and torch.equal(k_kv.kv_inverse(cm_arb, arb), x)):
        raise AssertionError("kv_delta arbitrary-beta round trip failed")
    elems = FLUSH_WINDOWS * WINDOW * CHANNELS
    b, by = bound_ms(4 * elems + FLUSH_WINDOWS * CHANNELS, 12 * elems)
    results["kv_delta_fwd"] = dict(
        name="kv_delta_fwd", route="cuda", source="src/repro_torch/csrc/kv_delta.cu",
        replaces="src/repro/kernels/kv_delta.py:28", max_abs_err=0.0,
        **timed(torch, lambda: k_kv.kv_forward(x)),
        plain_ms=timed(torch, lambda: k_kv.kv_forward_plain(x))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)
    # long context: a flush of 2048 windows
    xl = kv_windows(torch, LONG_WINDOWS, WINDOW, 7)
    got, beta = k_kv.kv_forward(xl)
    want, want_beta = k_kv.kv_forward_plain(xl)
    if not (torch.equal(beta, want_beta) and torch.equal(got, want)):
        raise AssertionError(f"kv_delta_fwd {tuple(xl.shape)} differs from "
                             "its plain version")
    elems = LONG_WINDOWS * WINDOW * CHANNELS
    warm_cold_line(
        torch, f"kv_delta_fwd long context ({LONG_WINDOWS} x {WINDOW} x "
        f"{CHANNELS})", "kv_fwd_kernel", lambda: k_kv.kv_forward(xl),
        lambda: k_kv.kv_forward_plain(xl),
        4 * elems + LONG_WINDOWS * CHANNELS, 12 * elems)
    del xl, got, want

    # -- read path on one decode slab: 8 windows, packed as the tier packs ---
    nwin = DECODE_ELEMS // (WINDOW * CHANNELS)
    win = x[:nwin].contiguous()
    cm, beta = k_kv.kv_forward(win)
    planes = k_bitplane.pack_planes_u16(cm.reshape(-1))       # (16, 8192)
    nbytes = planes.shape[1]
    starts = [i * WINDOW * CHANNELS for i in range(nwin)]
    part_planes, part_groups = partial_slab(torch, k_bitplane, k_kv)
    for view in read_views():
        ids = view.fetched_planes()
        rows = planes[list(ids)].contiguous()
        for rnd in (None, view):
            got = k_bitplane.unpack_planes(rows, ids, rnd)
            want = k_bitplane.unpack_planes_plain(
                rows, ids, k_bitplane.view_round_params(rnd))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bitplane_unpack ({view.name}, round "
                                     f"{rnd is not None}) differs")
        raw = k_bitplane.unpack_planes(rows, ids).view(nwin, CHANNELS, WINDOW)
        tok = k_kv.kv_inverse(raw, beta, view)
        want = k_kv.kv_inverse_plain(raw, beta, view)
        torch.cuda.synchronize()
        if not torch.equal(tok, want):
            raise AssertionError(f"kv_delta_inv ({view.name}) differs")
        if view.is_full and not torch.equal(tok, win):
            raise AssertionError("full-view readback is not lossless")
        cases = [(rows, starts, WINDOW, beta, win)] + [
            (part_planes[list(ids)].contiguous(), *g) for g in part_groups]
        for rws, sts, n, bt, wins in cases:
            got = k_bitplane.unpack_kv_windows(rws, ids, sts, n, CHANNELS, bt,
                                               view)
            want = k_bitplane.unpack_kv_windows_plain(rws, ids, sts, n,
                                                      CHANNELS, bt, view)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fused KV read ({view.name}, {len(sts)}"
                                     f" x {n} tokens) differs from its plain "
                                     "version")
            if view.is_full and not torch.equal(got, wins):
                raise AssertionError(f"fused KV read of {len(sts)} x {n} "
                                     "tokens is not lossless")
    man4 = read_views()[1]
    ids = man4.fetched_planes()
    rows = planes[list(ids)].contiguous()
    raw = k_bitplane.unpack_planes(rows, ids).view(nwin, CHANNELS, WINDOW)

    # the fused kernel alone, called as the wrapper calls it (the starts go
    # in the launch's parameters)
    lib = build.load("bitplane_unpack")
    code = k_bitplane.plane_code(ids)
    keep, cut, rnd = k_bitplane.view_round_params(man4)
    starts_host = torch.tensor(starts, dtype=torch.int64)
    out = torch.empty((nwin, WINDOW, CHANNELS), dtype=torch.int16,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def fused():
        build.check(lib.unpack_kv_windows(
            rows.data_ptr(), nbytes, len(ids), code, starts_host.data_ptr(),
            beta.data_ptr(), out.data_ptr(), nwin, WINDOW, CHANNELS, keep,
            cut, int(rnd), 0, stream), "bitplane_unpack")

    fused()
    torch.cuda.synchronize()
    if not torch.equal(out, k_kv.kv_inverse(raw, beta, man4)):
        raise AssertionError("fused KV read differs from unpack + inverse")
    elems = DECODE_ELEMS
    b, by = bound_ms(len(ids) * nbytes + nwin * CHANNELS + 8 * nwin
                     + 2 * elems, (3 * len(ids) + 20) * elems)
    results["bitplane_unpack"] = dict(
        name="bitplane_unpack", route="cuda",
        source="src/repro_torch/csrc/bitplane_unpack.cu",
        replaces="src/repro/kernels/bitplane.py:51", max_abs_err=0.0,
        **timed(torch, fused),
        plain_ms=timed(torch, lambda: k_bitplane.unpack_kv_windows_plain(
            rows, ids, starts, WINDOW, CHANNELS, beta, man4))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)
    chain = timed(torch, lambda: k_kv.kv_inverse(
        k_bitplane.unpack_planes(rows, ids).view(nwin, CHANNELS, WINDOW),
        beta, man4))
    alone = timed(torch, lambda: k_bitplane.unpack_planes(rows, ids))
    b1, _ = bound_ms(len(ids) * nbytes + 2 * elems, 3 * len(ids) * elems)
    b, by = bound_ms(4 * elems + nwin * CHANNELS, 20 * elems)
    results["kv_delta_inv"] = dict(
        name="kv_delta_inv", route="cuda", source="src/repro_torch/csrc/kv_delta.cu",
        replaces="src/repro/kernels/kv_delta.py:40", max_abs_err=0.0,
        **timed(torch, lambda: k_kv.kv_inverse(raw, beta, man4)),
        plain_ms=timed(torch, lambda: k_kv.kv_inverse_plain(raw, beta,
                                                            man4))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)
    r = results["bitplane_unpack"]
    print(f"[kernel] kv read fused (unpack -> inverse -> round, {nwin} x "
          f"{WINDOW} x {CHANNELS}, MAN4, {len(ids)} planes): "
          f"{r['ms'] * 1e3:.2f} us device, bound {r['bound_ms'] * 1e3:.3f} "
          f"us by {r['bound_by']}; the two-launch chain (standalone unpack, "
          f"then inverse + round) {chain['ms'] * 1e3:.2f} us "
          f"({chain['ms_from']}), {chain['call_ms'] * 1e3:.2f} us per call "
          "back to back; "
          f"standalone unpack {alone['ms'] * 1e3:.2f} us (bound "
          f"{b1 * 1e3:.3f} us), standalone inverse "
          f"{results['kv_delta_inv']['ms'] * 1e3:.2f} us", flush=True)


def partial_slab(torch, k_bitplane, k_kv):
    """Partial windows as a flush leaves them, stored one after another in
    one slab (3 of 37 tokens and 1 of 17 between them: channel boundaries
    inside bytes, members apart), each group's members in shuffled order.
    Returns the slab's 16 plane rows and per group (starts, n, beta,
    windows)."""
    a, b = kv_windows(torch, 3, 37, 4), kv_windows(torch, 1, 17, 5)
    (cm_a, beta_a), (cm_b, beta_b) = k_kv.kv_forward(a), k_kv.kv_forward(b)
    la, lb = 37 * CHANNELS, 17 * CHANNELS
    slab = torch.cat([cm_a[0].reshape(-1), cm_b[0].reshape(-1),
                      cm_a[1].reshape(-1), cm_a[2].reshape(-1)])
    order = [2, 0, 1]
    pos_a = [0, la + lb, 2 * la + lb]
    return k_bitplane.pack_planes_u16(slab), [
        ([pos_a[i] for i in order], 37, beta_a[order].contiguous(),
         a[order]),
        ([la], 17, beta_b, b)]


def check_elastic_matmul(torch, k_bitplane, k_mm, ops, results):
    """x (M, 896) against qwen2-0.5b's (896, 4864) MLP up-projection in
    K-packed planes, M in {1, 16}: within tolerance of the plain version
    at every view (P = 9..16 fetched planes), timed at the views without
    a round (r_m 0..7, d_m 0) and with one guard plane (d_m 1), beside
    each byte bound, torch.matmul on the dense weight and the kernel API
    call itself."""
    import numpy as np

    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.standard_normal((D_MODEL, D_FF)) * 0.02)
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    planes = k_mm.pack_weights_kmajor(w)
    errs, row = [], None
    for M in (1, 16):
        x = torch.from_numpy(rng.standard_normal((M, D_MODEL)).astype(
            np.float32)).cuda().to(torch.bfloat16)
        dense = x.float() @ w.float()
        lines = []
        for r_m in range(8):
            for d_m in range(8 - r_m):
                ids = ops.fetch_planes(8, r_m, d_m)
                fetched = planes[ids].contiguous()
                rnd = k_bitplane.round_params(8, r_m, d_m)
                got = k_mm.elastic_matmul_planes(x, fetched, ids, rnd)
                want = k_mm.elastic_matmul_plain(x, fetched, ids, rnd)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not bool((err <= MM_ATOL + MM_RTOL * want.abs()).all()):
                    raise AssertionError(
                        f"elastic_matmul (M={M}, r_m={r_m}, d_m={d_m}) max "
                        f"error {float(err.max())} beyond atol {MM_ATOL} "
                        f"rtol {MM_RTOL}")
                errs.append(float(err.max()))
                if r_m == 7 and not bool(((got - dense).abs()
                                          <= MM_ATOL + MM_RTOL * dense.abs()
                                          ).all()):
                    raise AssertionError("full-view elastic_matmul is not "
                                         "the dense product")
                if d_m > 1:
                    continue
                t = timed(torch, lambda: k_mm.elastic_matmul_planes(
                    x, fetched, ids, rnd))
                nbytes = 2 * M * D_MODEL + len(ids) * D_MODEL // 8 * D_FF \
                    + 4 * M * D_FF
                b, by = bound_ms(nbytes, 2 * M * D_MODEL * D_FF, BF16_FLOPS_S)
                lines.append(f"r_m {r_m} d_m {d_m} ({len(ids)} planes) "
                             f"{t['ms'] * 1e3:.2f} us (bound {b * 1e3:.3f} "
                             f"us)")
                if (M, r_m, d_m) == (1, 7, 0):
                    row = dict(
                        name="elastic_matmul", route="cuda",
                        source="src/repro_torch/csrc/elastic_matmul.cu",
                        replaces="src/repro/kernels/elastic_matmul.py:31",
                        **t, plain_ms=timed(
                            torch, lambda: k_mm.elastic_matmul_plain(
                                x, fetched, ids, rnd))["ms"],
                        bound_ms=b, bound_by=by)
        lib = timed(torch, lambda: torch.matmul(x, w))
        if M == 1:
            row["library_ms"] = lib["ms"]
        api = timed(torch, lambda: ops.elastic_matmul(x, planes, 7, 0))
        print(f"[kernel] elastic_matmul at the MLP up-projection, M={M}: "
              + "; ".join(lines), flush=True)
        print(f"[kernel] elastic_matmul M={M}: torch.matmul on the dense "
              f"bf16 weight {lib['ms'] * 1e3:.2f} us; kernels.ops."
              f"elastic_matmul (r_m 7, planes read in place) "
              f"{api['ms'] * 1e3:.2f} us device, {api['call_ms'] * 1e3:.2f} "
              "us per call back to back", flush=True)
    row["max_abs_err"] = max(errs)
    results["elastic_matmul"] = row


def kernel_api_path(torch, build, ops, k_mm):
    """The kernel API, the only path that reaches the elastic matmul (no
    serving path consumes it): each public function once at the main
    path's shapes, launch counts set to 0 just before and read just
    after.  Returns the launches."""
    import numpy as np

    rng = np.random.default_rng(9)
    w = torch.from_numpy((rng.standard_normal((D_MODEL, D_FF)) * 0.02)
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    planes = k_mm.pack_weights_kmajor(w)
    xs = [torch.from_numpy(rng.standard_normal((M, D_MODEL)).astype(
        np.float32)).cuda().to(torch.bfloat16) for M in (1, 16)]
    win = kv_windows(torch, 1, WINDOW, 10)[0]
    beta = torch.from_numpy(rng.integers(0, 256, CHANNELS).astype(
        np.uint8)).cuda()
    q = torch.from_numpy(rng.standard_normal((1, HEADS, HEAD_DIM)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal(
        (1, MAX_SEQ, KV_HEADS, HEAD_DIM)).astype(np.float32)).cuda().to(
        torch.bfloat16)
    torch.cuda.synchronize()
    build.reset_launches()
    stack = ops.bitplane_pack(win)
    full = ops.elastic_unpack(stack)
    man4 = ops.elastic_unpack(stack, 8, 4, 1)
    cm = ops.kv_transform(win, beta)
    back = ops.kv_transform_inv(cm, beta)
    outs = {(x.shape[0], r_m): ops.elastic_matmul(x, planes, r_m, d_m)
            for x in xs for r_m, d_m in ((7, 0), (4, 1), (0, 1))}
    att = ops.decode_attention(q, kv, kv, VALID_LEN)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if not (torch.equal(full, win) and torch.equal(back, win)):
        raise AssertionError("kernel API round trips are not lossless")
    if man4.shape != win.shape or att.shape != (1, HEADS, HEAD_DIM) \
            or not bool(torch.isfinite(att).all()):
        raise AssertionError("kernel API outputs have the wrong shape")
    for (M, r_m), out in outs.items():
        dense = xs[M != 1].float() @ w.float()
        rel = float((out - dense).norm() / dense.norm())
        if out.shape != (M, D_FF) or (r_m == 7 and rel > 1e-5) \
                or not rel < 0.35:
            raise AssertionError(f"kernel API elastic_matmul M={M} r_m={r_m}"
                                 f": relative error {rel}")
    print(f"[api] kernels.ops at the main path's shapes; launches "
          f"{launches}; elastic_matmul and kv_delta_inv are launched by "
          "this kernel API path only (serving consumes neither: its KV "
          "read is the fused bitplane_unpack)", flush=True)
    for name in API_ONLY_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the kernel API did not launch {name}")
    return launches


def launch_floor(torch) -> dict:
    """:func:`timed` of the smallest launch, a 16-byte ``zero_()``: the
    device time no kernel's launch goes below."""
    t = torch.ones(4, dtype=torch.int32, device="cuda")
    return timed(torch, t.zero_)


def check_pack_and_prep(torch, k_bitplane, k_lz4, gen, results):
    """The pack at one flush slab and at a 896 x 4864 weight, then the prep
    over each one's planes with and without run flags: bit-equal to the
    plain versions and across two calls, each timed back to back and from
    a cold L2 beside its bound, after the floor of one launch.  The JSON
    rows are the flush slab's: the pack, and the prep as the match path
    calls it (no run flags)."""
    floor = launch_floor(torch)
    print(f"[kernel] launch floor: a 16-byte zero_() {floor['ms'] * 1e3:.2f} "
          f"us device ({floor['ms_from']}), {floor['call_ms'] * 1e3:.2f} us "
          "per call back to back", flush=True)
    for n, label in ((SLAB_ELEMS, "flush slab"),
                     (PACK_LONG, f"{D_MODEL} x {D_FF} weight")):
        x = kv_like(torch, n, gen)
        got = k_bitplane.pack_planes_u16(x)
        if not (torch.equal(got, k_bitplane.pack_planes_plain(x))
                and torch.equal(got, k_bitplane.pack_planes_u16(x))):
            raise AssertionError(f"bitplane_pack at {n} elements differs from "
                                 "its plain version")
        pack = warm_cold_line(
            torch, f"bitplane_pack at the {label} ({n} elements)",
            "pack_planes_kernel", lambda: k_bitplane.pack_planes_u16(x),
            lambda: k_bitplane.pack_planes_plain(x), 4 * n, 64 * n)
        slab = got.reshape(-1)
        m = slab.numel()
        for runb in (True, False):
            out = k_lz4.lz4_prep(slab, runb=runb)
            want = k_lz4.prep_plain(slab, runb=runb)
            again = k_lz4.lz4_prep(slab, runb=runb)
            if (out[2] is None) == runb or not all(
                    torch.equal(g, w) and torch.equal(a, g)
                    for g, w, a in zip(out, want, again) if w is not None):
                raise AssertionError(f"lz4_prep ({m} B, runb {runb}) differs "
                                     "from its plain version")
            prep = warm_cold_line(
                torch, f"lz4_prep over its planes ({m} B) "
                + ("with run flags (13 B a position)" if runb else
                   "without run flags, as the match path calls it (9 B)"),
                "lz4_prep_kernel", lambda: k_lz4.lz4_prep(slab, runb=runb),
                lambda: k_lz4.prep_plain(slab, runb=runb),
                (13 if runb else 9) * m, 10 * m)
        if n != SLAB_ELEMS:
            continue
        keep = ("ms", "call_ms", "ms_from", "plain_ms", "bound_ms", "bound_by")
        results["bitplane_pack"] = dict(
            name="bitplane_pack", route="cuda",
            source="src/repro_torch/csrc/bitplane_pack.cu",
            replaces="src/repro/kernels/bitplane.py:38", max_abs_err=0.0,
            library_ms=None, **{k: pack[k] for k in keep})
        results["lz4_prep"] = dict(
            name="lz4_prep", route="cuda",
            source="src/repro_torch/csrc/lz4_prep.cu",
            replaces="src/repro/kernels/lz4.py:486", max_abs_err=0.0,
            library_ms=None, **{k: prep[k] for k in keep})


def check_kernels(torch, k_bitplane, k_lz4, k_attn, results):
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_pack_and_prep(torch, k_bitplane, k_lz4, gen, results)

    # -- decode attention: bf16 and fp8 caches ----------------------------------
    q = torch.randn((1, HEADS, HEAD_DIM), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((1, MAX_SEQ, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((1, MAX_SEQ, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    split = k_attn.SPLIT_POSITIONS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = []
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        kc, vc = k.to(dt), v.to(dt)
        # the main path's length, one block, block boundaries +-1, all of S
        for valid in (VALID_LEN, 1, 77, split - 1, split, split + 1,
                      2 * split + 1, VALID_LEN + 1, MAX_SEQ):
            got = k_attn.decode_attention(q, kc, vc, valid)
            want = k_attn.decode_attention_plain(q, kc, vc, valid)
            again = k_attn.decode_attention(q, kc, vc, valid)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not bool((err <= ATOL + RTOL * want.abs()).all()):
                raise AssertionError(
                    f"decode_attn ({dt}, valid_len={valid}) max error "
                    f"{float(err.max())} beyond atol {ATOL} rtol {RTOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"decode_attn ({dt}, valid_len={valid}) "
                                     "differs between two calls")
            errs.append(float(err.max()))
    b, by = attn_bound(VALID_LEN, HEADS, KV_HEADS, HEAD_DIM)
    sdpa_ms = sdpa_backends(torch, q, k, v, VALID_LEN)
    results["decode_attn"] = dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:36",
        max_abs_err=max(errs),
        **timed(torch, lambda: k_attn.decode_attention(q, k, v, VALID_LEN)),
        plain_ms=timed(torch, lambda: k_attn.decode_attention_plain(
            q, k, v, VALID_LEN))["ms"],
        bound_ms=b, bound_by=by,
        library_ms=min(sdpa_ms.values()) if sdpa_ms else None)
    print("[kernel] SDPA yardstick at the main path's shape, by backend: "
          + "; ".join(f"{name} {ms * 1e3:.2f} us"
                      for name, ms in sdpa_ms.items()), flush=True)
    # what a call costs: one block alone, then blocks merged on chip
    parts = []
    for valid in (split, 2 * split, VALID_LEN):
        blocks = -(-valid // k_attn.split_size(valid, KV_HEADS, sms))
        t = timed(torch, lambda: k_attn.decode_attention(q, k, v, valid))
        parts.append(f"valid_len {valid}: {t['ms'] * 1e3:.2f} us, {blocks} "
                     f"block{'s' * (blocks > 1)} per KV head")
    print("[kernel] decode_attn by split: " + "; ".join(parts), flush=True)

    # -- decode attention at long context: same heads, longer caches --------
    lines = []
    for S in (4096, 32768):
        ql = torch.randn((1, HEADS, HEAD_DIM), generator=gen,
                         device="cuda").to(torch.bfloat16)
        kl, vl = (torch.randn((1, S, KV_HEADS, HEAD_DIM), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        got = k_attn.decode_attention(ql, kl, vl, S)
        want = k_attn.decode_attention_plain(ql, kl, vl, S)
        torch.cuda.synchronize()
        if not bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all()):
            raise AssertionError(f"decode_attn at valid_len {S} beyond "
                                 "tolerance")
        t = timed(torch, lambda: k_attn.decode_attention(ql, kl, vl, S))
        b, by = attn_bound(S, HEADS, KV_HEADS, HEAD_DIM)
        lib = sdpa_backends(torch, ql, kl, vl, S)
        blocks = -(-S // k_attn.split_size(S, KV_HEADS, sms))
        lines.append(f"valid_len {S}: {t['ms'] * 1e3:.2f} us (bound "
                     f"{b * 1e3:.3f} us by {by}; {blocks} blocks per KV "
                     "head; SDPA fastest "
                     + (f"{min(lib.values()) * 1e3:.2f} us)" if lib else "-)"))
    print("[kernel] decode_attn at long context, q (1, 14, 64) over a bf16 "
          "cache: " + "; ".join(lines), flush=True)


def flush_slab(torch, k_bitplane, k_kv, seed: int):
    """One flush's encode slab as the tier builds it on the card: KV
    windows through the exponent-delta forward and the pack, 16 planes x
    16 windows = 256 streams of 1024 bytes.  Returns the slab and the
    streams' bounds the pre-screen leaves to the match (the others are
    gaps)."""
    import numpy as np

    from repro_torch.core import codec

    x = kv_windows(torch, SLAB_ELEMS // (WINDOW * CHANNELS), WINDOW, seed)
    cm, _ = k_kv.kv_forward(x)
    planes = k_bitplane.pack_planes_u16(cm.reshape(-1))
    slab = planes.reshape(-1).view(torch.uint8)
    nb = WINDOW * CHANNELS // 8
    starts = (np.arange(16)[:, None] * planes.shape[1]
              + np.arange(x.shape[0])[None, :] * nb).ravel()
    ends = starts + nb
    keep = ~codec._prescreen_slab(slab.cpu().numpy(), starts, ends)
    return slab, starts[keep], ends[keep]


def far_pair(np, token, dist: int):
    """``token``, zeros, ``token`` again ``dist`` bytes on, zeros."""
    out = np.zeros(dist + token.size + 64, np.uint8)
    out[: token.size] = token
    out[dist : dist + token.size] = token
    return out


def match_bytes(np, starts, ends, n_events: int) -> int:
    """Bytes the match kernel must move: of each stream longer than
    MFLIMIT + 1 bytes the int32 word and hash of its L - 3 positions, the
    four int64 meta entries and the int32 count of every stream, and 12 B
    (pos, dist, mlen) an event."""
    L = np.asarray(ends) - np.asarray(starts)
    return int(8 * (L - 3)[L > 13].sum() + 36 * L.size + 12 * n_events)


def check_lz4_match(torch, k_bitplane, k_kv, k_lz4, results):
    """The LZ4 match kernel against the plain pipeline on the card and the
    numpy twin, event for event: the main path's flush slab (gaps where the
    pre-screen bypasses), a gapped slab of mixed streams, a periodic
    stream, and streams longer than 65536 bytes that reach the 0xFFFF
    window (the global-scratch path); timed at the flush slab."""
    import numpy as np

    rng = np.random.default_rng(4)
    slab, st, en = flush_slab(torch, k_bitplane, k_kv, 3)
    parts = [np.where(rng.random(4096) < p, rng.integers(0, 256, 4096), 0)
             .astype(np.uint8) for p in (0.0, 0.01, 0.3, 1.0)]
    mixed = np.concatenate([np.concatenate([rng.integers(0, 256, 100)
                                            .astype(np.uint8), q])
                            for q in parts])
    m_st = 100 + np.arange(4) * 4196
    token = rng.integers(1, 256, 40).astype(np.uint8)
    far = np.concatenate([far_pair(np, token, 65535),
                          far_pair(np, token, 65636)])
    cases = {
        "flush slab (256 x 1024 B, pre-screened)": (slab, st, en),
        "gapped mixed streams": (torch.from_numpy(mixed).cuda(), m_st,
                                 m_st + 4096),
        "periodic 3900 B": (torch.from_numpy(np.tile(
            rng.integers(0, 256, 13).astype(np.uint8), 300)).cuda(),
            np.array([0]), np.array([3900])),
        "two streams of 65.6 KB, repeats 65535 and 65636 B back": (
            torch.from_numpy(far).cuda(), np.array([0, far.size // 2]),
            np.array([far.size // 2, far.size])),
    }
    lines = []
    for what, (buf, s, e) in cases.items():
        got = k_lz4.lz4_match(buf, s, e)
        plain = k_lz4.match_plain(buf, s, e)
        twin = k_lz4.match_events_slab(buf.cpu().numpy(), s, e,
                                       force="numpy")
        for g, p, t in zip(got, plain, twin):
            if not (np.array_equal(g, p) and np.array_equal(g, t)):
                raise AssertionError(f"lz4_match differs on {what}")
        lines.append(f"{what}: {got[0].size} events")
    if not (65535 in got[1] and (got[1] <= 0xFFFF).all()):
        raise AssertionError("the 0xFFFF window case selected the wrong "
                             f"distances: {sorted(set(got[1].tolist()))}")

    # the match launch alone, as the wrapper makes it, at the flush slab
    pos, _, _ = k_lz4.match_events_slab(slab.cpu().numpy(), st, en,
                                        force="numpy")
    match, out, rows = k_lz4.match_launch(slab, st, en)
    match()
    if not np.array_equal(k_lz4.match_result(out, rows)[0], pos):
        raise AssertionError("the match launch alone differs from the twin")
    S, covered = st.size, int((en - st).sum())
    b, by = bound_ms(match_bytes(np, st, en, pos.size), 0)
    plain = timed(torch, lambda: k_lz4.match_plain(slab, st, en), iters=3)
    wrapper = timed(torch, lambda: k_lz4.lz4_match(slab, st, en), iters=20)
    t0 = time.perf_counter()
    for _ in range(3):
        k_lz4.match_plain(slab, st, en)
    plain_wall = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    for _ in range(20):
        k_lz4.lz4_match(slab, st, en)
    wrapper_wall = (time.perf_counter() - t0) / 20
    results["lz4_match"] = dict(
        name="lz4_match", route="cuda",
        source="src/repro_torch/csrc/lz4_match.cu",
        replaces="src/repro/kernels/lz4.py:593", max_abs_err=0.0,
        **timed(torch, match), plain_ms=plain["ms"], bound_ms=b,
        bound_by=by, library_ms=None)
    r = results["lz4_match"]
    print(f"[kernel] lz4_match == plain pipeline == numpy twin on: "
          + "; ".join(lines), flush=True)
    print(f"[kernel] lz4_match at the flush slab ({S} streams, {covered} "
          f"B, {pos.size} events): the match launch {r['ms'] * 1e3:.2f} us "
          f"device ({r['ms_from']}), bound {r['bound_ms'] * 1e3:.3f} us "
          f"(the words and hashes it reads + meta + events); the wrapper "
          f"(prep + match + one copy back) {wrapper['ms'] * 1e3:.2f} us "
          f"device, "
          f"{wrapper_wall * 1e3:.3f} ms wall per call; plain pipeline on "
          f"the card (what serving ran before this kernel) "
          f"{plain['ms']:.3f} ms device, {plain_wall * 1e3:.1f} ms wall per "
          "call", flush=True)


def attn_bound(valid: int, heads: int, kv_heads: int, hd: int) -> tuple:
    """Bound of one bf16 decode-attention call: K and V rows below
    ``valid`` read once, q read and the f32 output written once."""
    nbytes = 2 * valid * kv_heads * hd * 2 + heads * hd * 2 + heads * hd * 4
    return bound_ms(nbytes, 4 * heads * valid * hd)


def sdpa_backends(torch, q, k, v, valid: int) -> dict:
    """Device time of ``scaled_dot_product_attention`` over the same valid
    prefix under each backend that takes these shapes (KV heads expanded
    outside the timed call; the port never calls it)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[2]
    kx = k[:, :valid].repeat_interleave(group, dim=2).transpose(1, 2)
    vx = v[:, :valid].repeat_interleave(group, dim=2).transpose(1, 2)
    kx, vx = kx.contiguous(), vx.contiguous()
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                sdpa(q4, kx, vx)
                torch.cuda.synchronize()
                out[name.lower()] = timed(
                    torch, lambda: sdpa(q4, kx, vx))["ms"]
        except RuntimeError:          # this backend refuses these shapes
            continue
    return out


def check_tier_and_model(torch):
    """The card's tier against the CPU's on the same KV pages — encode,
    readback at every view the tier reads with, PNM gathers — and the
    card's model against the CPU's on a small input."""
    import numpy as np

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core.precision import MAN4, PrecisionView
    from repro_torch.core.tier import (
        KV, TENSOR, GatherReq, ReadReq, WriteReq, make_device,
    )
    from repro_torch.models.model import decode_step, init_cache, init_params

    rng = np.random.default_rng(1)
    pages = [(rng.standard_normal((64, CHANNELS)) * 0.5)
             .astype(np.float32) for _ in range(24)]
    u16 = [(p.view(np.uint32) >> 16).astype(np.uint16) for p in pages]
    edges = kv_windows(torch, 1, 64, 11)[0].cpu().numpy().view(np.uint16)
    writes = [WriteReq(f"p{i}", u, kind=KV) for i, u in enumerate(u16)]
    views = [v for v in read_views() if not v.name.startswith("cut")]
    wide = PrecisionView(r_m=2, d_m=4, name="wide")   # MAN4 block: cut11
    more = [WriteReq("edges", edges, kind=KV),
            WriteReq("part", u16[0][:37], kind=KV),
            WriteReq("w", u16[1].ravel(), kind=TENSOR)]
    reads = [ReadReq(k, kind=KV, view=v) for k in [f"p{i}" for i in
                                                   range(len(u16))]
             + ["edges", "part"] for v in views] \
        + [ReadReq("w", view=v) for v in views]
    reread = [ReadReq(k, kind=kind, view=v)
              for k, kind in (("p1", KV), ("edges", KV), ("w", TENSOR))
              for v in views + [wide]]
    out = {}
    for dev in ("cuda", "cpu"):
        tier = make_device("trace", device=dev)
        recs = tier.submit(writes + more) + tier.submit(reads)
        tier.truncate_planes(["p1", "edges", "w"], MAN4)
        out[dev] = recs + tier.submit(reread)
    for a, b in zip(out["cuda"], out["cpu"]):
        fa = {k: v for k, v in vars(a).items() if k != "data"}
        fb = {k: v for k, v in vars(b).items() if k != "data"}
        if fa != fb:
            raise AssertionError(f"tier receipt differs cuda/cpu: {fa} {fb}")
        if (a.data is None) != (b.data is None) or (
                a.data is not None and not np.array_equal(a.data, b.data)):
            raise AssertionError(f"tier readback differs cuda/cpu: {a.key}")

    # PNM gathers over the same 24 pages: scores bit-equal (same order of
    # summation on both), receipts, winners and winner bytes identical
    digest = rng.standard_normal(CHANNELS).astype(np.float32)
    keys = tuple(f"p{i}" for i in range(len(u16)))
    for dev in ("cuda", "cpu"):
        tier = make_device("trace", device=dev)
        tier.submit(writes)
        out[dev] = tier.submit([GatherReq(keys, digest, k=k)
                                for k in (0, 5, 24)]
                               + [GatherReq(keys, digest, k=24,
                                            views=tuple(views[i % 4]
                                                        for i in range(24)))])
    for a, b in zip(out["cuda"], out["cpu"]):
        skip = ("data", "gather")
        fa = {k: v for k, v in vars(a).items() if k not in skip}
        fb = {k: v for k, v in vars(b).items() if k not in skip}
        if fa != fb:
            raise AssertionError(f"gather receipt differs cuda/cpu: {fa} {fb}")
        ga, gb = a.gather, b.gather
        if ga.scores.tobytes() != gb.scores.tobytes():
            raise AssertionError("gather scores differ cuda/cpu: max "
                                 f"{np.abs(ga.scores - gb.scores).max()}")
        if (ga.keys, ga.indices) != (gb.keys, gb.indices) or any(
                not np.array_equal(x, y) for x, y in zip(ga.data, gb.data)) \
                or len(ga.data) != len(gb.data):
            raise AssertionError(f"gather winners differ cuda/cpu: "
                                 f"{ga.keys} {gb.keys}")

    # the per-block encoder on the card: the batched store's bytes and
    # receipts on the same tensor and KV writes; a pack launch for each
    # block, a prep and a match launch for each block with a plane
    # stream the pre-screen keeps (counted as the CPU store's match calls)
    from repro_torch.core import codec as codecs
    from repro_torch.kernels import build

    match = codecs.klz4.match_events_slab
    state, per_block = {}, {}
    for batched, where in ((True, "cuda"), (False, "cuda"), (False, "cpu")):
        tier = make_device("trace", device=where, batched_encode=batched)
        calls = []
        codecs.klz4.match_events_slab = \
            lambda *a, **kw: calls.append(1) or match(*a, **kw)
        before = dict(build.LAUNCHES)
        try:
            recs = tier.submit(writes + more)
            torch.cuda.synchronize()
        finally:
            codecs.klz4.match_events_slab = match
        got = {k: build.LAUNCHES[k] - before[k]
               for k in ("bitplane_pack", "lz4_prep", "lz4_match")}
        blocks = sum(r.blocks for r in recs)
        state[batched, where] = (
            [(k, [(b.payloads, b.flags) for b in bl])
             for k, bl in tier._tensors.items()],
            [{k: v for k, v in vars(r).items() if k != "data"}
             for r in recs])
        per_block[batched, where] = (got, blocks, len(calls))
    (got, blocks, n_match), (_, _, cpu_match) = (per_block[False, "cuda"],
                                                  per_block[False, "cpu"])
    if not (got["bitplane_pack"] == blocks and
            0 < got["lz4_prep"] == got["lz4_match"] == n_match == cpu_match):
        raise AssertionError(f"the per-block encoder on the card launched "
                             f"{got} for {blocks} blocks, {cpu_match} of "
                             "them with a kept stream")
    if not state[True, "cuda"] == state[False, "cuda"] == state[False, "cpu"]:
        raise AssertionError("the per-block encoder on the card differs "
                             "from the batched one or the CPU's")
    print(f"[check] per-block encoder on the card: {blocks} blocks, "
          f"launches {got} ({cpu_match} blocks with a kept stream); the "
          f"batched store's {per_block[True, 'cuda'][0]}", flush=True)
    check_pool_prefetch(torch)

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 40)))
    logits = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        cache = init_cache(cfg, 1, 64, device=dev)
        lg, cache = decode_step(cfg, p, {"tokens": toks.to(dev),
                                         "cache_pos": 0}, cache)
        steps = [lg[:, -1].float().cpu()]
        for t in range(4):
            nxt = toks[:, t : t + 1].to(dev)
            lg, cache = decode_step(cfg, p, {"tokens": nxt,
                                             "cache_pos": 40 + t}, cache)
            steps.append(lg[:, -1].float().cpu())
        logits[dev] = torch.stack(steps)
    if not bool(torch.isfinite(logits["cuda"]).all()):
        raise AssertionError("non-finite logits on the card")
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    # bf16 matmuls round at other places on the card: a few bf16 ulps
    if diff > 0.05 * scale:
        raise AssertionError(f"card logits differ from CPU by {diff} "
                             f"(scale {scale})")
    return diff


def check_pool_prefetch(torch, dev="cuda"):
    """A full-width KV pool (24 layers, K and V, 128 channels, 64-token
    pages, two thirds spilled) on the card: each layer's prefetch, issued
    one layer ahead of its read, then ``read_layer``, equals a plain
    ``read_layer`` pool, words and tier stats."""
    import numpy as np

    from repro_torch.runtime import PAPER_POLICY, KVPagePool

    layers, windows = 24, 6
    page = WINDOW * CHANNELS * 2
    pages = kv_windows(torch, layers * 2 * windows, WINDOW, 21).cpu() \
        .numpy().view(np.uint16)
    pools = []
    for _ in range(2):
        pool = KVPagePool("trace", page_tokens=WINDOW,
                          hbm_budget_bytes=layers * 2 * 2 * page,
                          policy=PAPER_POLICY, device=dev)
        it = iter(pages)
        for w in range(windows):
            pool.append_pages([(l, kind, WINDOW * w, next(it), float(w))
                               for l in range(layers) for kind in "kv"])
        pools.append(pool)
    plain, pre = pools
    order = [(l, kind) for l in range(layers) for kind in "kv"]
    want = [plain.read_layer(*lk) for lk in order]
    issued = pre.prefetch_layer(*order[0])
    got = []
    for i, lk in enumerate(order):
        if i + 1 < len(order):
            issued += pre.prefetch_layer(*order[i + 1])
        got.append(pre.read_layer(*lk))
    if issued != pre.spilled_pages or pre._prefetched:
        raise AssertionError(f"prefetch issued {issued} of "
                             f"{pre.spilled_pages} spilled pages")
    if not all(np_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("prefetch + read_layer differs from read_layer")
    fields = [f for f in vars(plain.stats()) if not f.startswith("_")]
    a = {f: getattr(plain.stats(), f) for f in fields}
    b = {f: getattr(pre.stats(), f) for f in fields}
    if a != b:
        raise AssertionError(f"prefetch changed the tier stats: {a} {b}")
    print(f"[check] pool prefetch at full width ({layers} layers x K/V, "
          f"{pre.spilled_pages} of {len(pages)} pages spilled): "
          f"prefetch_layer + read_layer == read_layer, stats identical",
          flush=True)


class PoolLog:
    """Every page-pool call an engine makes, by page key, to replay on
    another pool."""

    def __init__(self, pool):
        self.calls = []
        for name in ("append_pages", "read_pages", "read_pages_async",
                     "drain_reads"):
            self._wrap(pool, name)

    def _wrap(self, pool, name):
        fn = getattr(pool, name)

        def logged(arg):
            if name == "append_pages":
                self.calls.append((name, [tuple(e) for e in arg]))
            elif name == "drain_reads":
                self.calls.append((name, [t.request.key for t in arg]))
            else:
                self.calls.append((name, [p.key for p in arg]))
            return fn(arg)
        setattr(pool, name, logged)

    def replay(self, pool):
        tickets = {}
        for name, arg in self.calls:
            if name == "append_pages":
                pool.append_pages(arg)
                pool.spill_events = []
            elif name == "drain_reads":
                pool.drain_reads([tickets.pop(k) for k in arg])
            else:
                by_key = {p.key: p for p in pool.iter_pages()}
                pages = [by_key[k] for k in arg]
                if name == "read_pages":
                    pool.read_pages(pages)
                else:
                    tickets.update(zip(arg, pool.read_pages_async(pages)))


def check_readback_helpers(torch, cfg, params, dev="cuda",
                           budget: int = 1 << 22):
    """``ServeEngine.kv_through_tier`` and ``layer_traffic`` of one
    request served as [main] serves it: every layer's K and V round trip
    and the per-layer traffic equal a CPU pool's fed the engine's page
    stream."""
    import numpy as np

    from repro_torch.runtime import PAPER_POLICY, KVPagePool, ServeEngine

    eng = ServeEngine(cfg, params, max_seq=512 + 64 + 64, batch=1,
                      page_tokens=64, hbm_kv_budget=budget,
                      policy=PAPER_POLICY, device=dev)
    log = PoolLog(eng.pool)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (1, 512))
    eng.generate(prompt.astype(np.int32), 64)
    eng.flush_io()      # the last boundary's readback, into the log
    cpu = KVPagePool("trace", page_tokens=64, hbm_budget_bytes=budget,
                     policy=PAPER_POLICY, device="cpu")
    log.replay(cpu)
    traffic = eng.layer_traffic()
    if eng.pool.spilled_pages <= 0 or 0 not in traffic:
        raise AssertionError("the request spilled nothing")
    if {k: vars(v) for k, v in traffic.items()} != \
            {k: vars(v) for k, v in cpu.traffic_by_layer().items()}:
        raise AssertionError("layer_traffic differs from the CPU pool's")
    for layer in range(cfg.n_layers):
        for kind in "kv":
            a = eng.kv_through_tier(layer, kind)
            if a.shape != (576, cfg.n_kv_heads * cfg.hd) or not np_equal(
                    a, cpu.read_layer(layer, kind)):
                raise AssertionError(f"kv_through_tier({layer}, {kind}) "
                                     "differs from the CPU pool's")
    if {k: vars(v) for k, v in eng.layer_traffic().items()} != \
            {k: vars(v) for k, v in cpu.traffic_by_layer().items()}:
        raise AssertionError("layer_traffic after the round trips differs")
    spilled = eng.pool.spilled_pages
    eng.retire()
    print(f"[check] kv_through_tier of every layer's K and V and "
          f"layer_traffic of one [main] request ({spilled} pages spilled, "
          f"layer 0: {traffic[0].requests} requests, "
          f"{traffic[0].dram_bytes_read} B DRAM read) == a CPU pool fed "
          f"its page stream", flush=True)


# Host functions whose cumulative time splits one served request.
_SPANS = (
    ("prefill", "runtime/serving.py", "prefill"),
    ("decode steps", "runtime/serving.py", "decode"),
    ("model forward", "models/model.py", "decode_step"),
    ("cache windows to host", "runtime/serving.py", "_commit_pages"),
    ("tier encode", "core/tier.py", "_encode_commit"),
    ("  KV forward on card", "core/tier.py", "_transform_kv_windows"),
    ("  LZ4 match on card", "kernels/lz4.py", "lz4_match"),
    ("  LZ4 emit (host)", "core/codec.py", "lz4_emit_events"),
    ("tier decode", "core/tier.py", "_do_reads"),
    ("  unpack + inverse on card", "core/tier.py", "_decode_planes"),
    ("  PNM gather", "core/tier.py", "_do_gather"),
    ("  page scoring", "kernels/pnm_score.py", "page_scores_u16"),
    ("attention importance", "runtime/serving.py",
     "_apply_attention_importance"),
    ("  LZ4 decompress (host)", "core/codec.py", "lz4_decompress"),
    ("readback into cache", "runtime/serving.py", "_apply_readback"),
)


def profile_request(torch, serve, params, device_time=True, **overrides):
    """Where one full-width request's time goes: host split from cProfile
    (cumulative seconds of the spans above), then (``device_time``)
    device busy time from ``torch.profiler`` over a second, identical
    request."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    kw = dict(arch="qwen2-0.5b", device="trace", prompt_len=512, n_tokens=64,
              batch=1, requests=1, hbm_kv_budget=1 << 22, page_tokens=64,
              seed=1, torch_device="cuda", params=params, verbose=False)
    kw.update(overrides)
    prof = cProfile.Profile()
    prof.enable()
    rep = serve(**kw)
    prof.disable()
    stats = pstats.Stats(prof).stats
    parts = []
    for label, path, fn in _SPANS:
        ct = sum(v[3] for k, v in stats.items()
                 if k[2] == fn and k[0].endswith(path))
        parts.append(f"{label} {ct:.3f}")
    label = "PNM request" if kw.get("pnm_topk") is not None else "request"
    print(f"[profile] one {label} under cProfile: wall {rep.wall_s:.3f} s; "
          + "; ".join(parts) + " (s, cumulative)", flush=True)
    if not device_time:
        return

    # device activity only: CPU-op tracing of a whole request costs
    # minutes of post-processing
    with profile(activities=[ProfilerActivity.CUDA]) as tprof:
        rep = serve(**kw)
    evts = [(e.key, _self_device_us(e), e.count)
            for e in tprof.key_averages()]
    busy_s = sum(us for _, us, _ in evts) / 1e6
    top = sorted(evts, key=lambda t: -t[1])[:5]
    attn_s = sum(us for k, us, _ in evts if "decode_attn" in k) / 1e6
    print(f"[profile] one request under torch.profiler: wall "
          f"{rep.wall_s:.3f} s, device busy {busy_s:.3f} s "
          f"({100 * busy_s / rep.wall_s:.1f}%), {sum(n for *_, n in evts)} "
          f"kernels; decode attention {attn_s * 1e3:.1f} ms "
          f"({100 * attn_s / busy_s:.1f}% of busy); top: "
          + "; ".join(f"{k[:60]} {us / 1e3:.1f} ms x{n}" for k, us, n in top),
          flush=True)


def pnm_path(torch, serve, build, params):
    """The PNM path at full width, one request per case, launch counts set
    to 0 just before each case and read just after.  Returns the summed
    launches of the path's cases."""
    kw = dict(arch="qwen2-0.5b", smoke=False, device="trace", prompt_len=512,
              n_tokens=64, batch=1, requests=1, hbm_kv_budget=1 << 22,
              page_tokens=64, seed=0, torch_device="cuda", params=params,
              verbose=False)
    cases = {
        "a classic": {},
        "b covering gather": dict(pnm_topk=1 << 20),
        "c top-16, attention": dict(pnm_topk=16, importance="attention"),
        "d c on 4 shards": dict(pnm_topk=16, importance="attention",
                                shards=4, placement="hash-stripe"),
    }
    from repro_torch.kernels import pnm_score as k_pnm

    reps, total = {}, {name: 0 for name in build.KERNELS}
    score_wall = []
    wrapper = k_pnm.page_scores_u16

    def timed_scores(*args, **kwargs):
        t0 = time.perf_counter()
        out = wrapper(*args, **kwargs)       # returns on the host: synced
        score_wall.append(time.perf_counter() - t0)
        return out

    for case, extra in cases.items():
        build.reset_launches()
        k_pnm.page_scores_u16 = timed_scores
        try:
            rep = serve(**kw, **extra)
        finally:
            k_pnm.page_scores_u16 = wrapper
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        toks = rep.tokens[0]
        if toks.shape != (1, 64) or toks.min() < 0 or toks.max() >= VOCAB:
            raise AssertionError(f"{case}: bad tokens {toks.shape}")
        print(f"[pnm] {case}: wall tok/s {rep.tok_s:.3f}; tier link out "
              f"{rep.tier_link_out} B, DRAM read {rep.tier_dram_read} B; "
              f"spilled {rep.spilled_pages}, read back "
              f"{rep.readback_pages}, gathered {rep.gathered_pages}; "
              f"launches {launches}", flush=True)
        reps[case] = rep
        check_serving_launches(case, launches)
        if launches["kv_delta_inv"]:
            raise AssertionError(f"{case}: the KV read launched the "
                                 "standalone inverse")
        if extra:
            if launches["pnm_score"] <= 0 or rep.gathered_pages <= 0:
                raise AssertionError(f"{case}: no gather on the card")
            for name in total:
                total[name] += launches[name]
    a, b, c, d = reps.values()
    if not np_equal(a.tokens[0], b.tokens[0]):
        raise AssertionError("covering gather changed the tokens")
    if not np_equal(c.tokens[0], d.tokens[0]):
        raise AssertionError("4 shards changed the top-16 tokens")
    if not c.tier_link_out < a.tier_link_out:
        raise AssertionError(f"top-16 shipped {c.tier_link_out} B, classic "
                             f"{a.tier_link_out} B")
    if a.readback_pages <= 0 or b.readback_pages != 0:
        raise AssertionError("classic case read nothing back, or the "
                             "covering gather fell back to readback")
    tokens = 3 * 64
    print(f"[pnm] b == a tokens, d == c tokens; c ships "
          f"{c.tier_link_out / a.tier_link_out:.4f}x a's link bytes; "
          f"pnm_score {total['pnm_score'] / tokens:.4f} launches per token "
          f"over b-d ({total['pnm_score']} in {tokens} tokens); the "
          f"page_scores_u16 wrapper "
          f"{1e3 * sum(score_wall) / len(score_wall):.3f} ms wall per "
          f"gather and shard (mean of {len(score_wall)}, min "
          f"{1e3 * min(score_wall):.3f})", flush=True)
    return total


# the kernels every serving path launches: a spill flush's KV forward,
# pack, prep and match; the KV read of every readback or gather (one
# fused bitplane_unpack launch per window group); decode attention
SERVING_KERNELS = ("bitplane_pack", "lz4_prep", "lz4_match", "decode_attn",
                   "kv_delta_fwd", "bitplane_unpack")


def check_serving_launches(tag: str, launches: dict):
    """A serving path's launch counts (set to 0 just before it ran, read
    just after): each serving kernel above 0, the match once a flush."""
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched")
    if launches["lz4_match"] != launches["lz4_prep"]:
        raise AssertionError(f"{tag}: the match kernel did not launch once "
                             f"per flush: {launches}")


# [sched] and [streams]: the continuous-batching half of serving at full
# width.  Six requests of 512 prompt + 64 new tokens whose prompts share
# their first 256 tokens (4 of the 8 prompt windows), arriving as a
# Poisson process at 0.5 a decode round (ticks 2, 4, 4, 4, 5, 8), three
# batch slots, 64-token pages, a 4 MiB HBM budget per request.
SCHED_TRACE = dict(n_requests=6, rate=0.5, kind="poisson", prompt_len=512,
                   new_tokens=64, seed=0, share_prefix_len=256)
SCHED_ENGINE = dict(page_tokens=64, hbm_kv_budget=1 << 22)
# the admission capacity in projections: with the tier's ratio near 1.4
# the first request and one follower (charged only its novel KV) fit and
# the next follower waits for the first to retire
CAPACITY_PROJECTIONS = 1.5


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _solo_tokens(cfg, params, dev, engine_kw, max_seq, prompt, n, seed):
    """One request alone through a ServeEngine on its own tier."""
    from repro_torch.runtime import PAPER_POLICY, ServeEngine

    eng = ServeEngine(cfg, params, max_seq=max_seq, batch=1,
                      device_kind="trace", policy=PAPER_POLICY, device=dev,
                      **engine_kw)
    toks = eng.generate(prompt, n, seed=seed)
    eng.retire()
    return toks


def _tier_empty(tag: str, tier):
    blocks = sum(s.stats.blocks for s in getattr(tier, "shards", [tier]))
    if tier.resident_bytes() != 0 or blocks != 0:
        raise AssertionError(f"{tag}: the tier holds {tier.resident_bytes()} "
                             f"B in {blocks} blocks after the run")


class SharedWindowProbe:
    """Wraps ``ServeEngine.prefill``: after a prefill wired to a prefix
    index, each stored shared page of prompt windows 0-1 (layers 0 and
    last, K and V) that this request acquired (refcount >= 2) is read back
    at FULL and held against the window its own cache computed.  The
    probe's reads count in the tier's traffic."""

    def __init__(self, torch, engine_cls):
        import numpy as np

        from repro_torch.core.precision import FULL
        from repro_torch.core.tier import KV, ReadReq
        from repro_torch.runtime.paging import shared_page_key

        self.cls, self.original = engine_cls, engine_cls.prefill
        self.checked = self.mismatched = 0
        probe = self

        def prefill(eng, tokens):
            logits = probe.original(eng, tokens)
            if eng.pool.prefix_index is None:
                return logits
            tier, page = eng.pool.tier, eng.page_tokens
            for w, h in enumerate(eng._share_hashes[:2]):
                for layer in (0, eng.cfg.n_layers - 1):
                    for kind in ("k", "v"):
                        key = shared_page_key(h, layer, kind)
                        if tier.refcount(key) < 2:
                            continue
                        own = eng.cache["layers"][kind][
                            layer, :, w * page:(w + 1) * page]
                        own = own.cpu().contiguous().view(torch.int16) \
                            .numpy().view(np.uint16).reshape(page, -1)
                        stored = tier.submit([ReadReq(key, kind=KV,
                                                      view=FULL)])[0].data
                        probe.checked += 1
                        probe.mismatched += not np.array_equal(own, stored)
            return logits

        engine_cls.prefill = prefill

    def restore(self):
        self.cls.prefill = self.original


def drive_scheduler(torch, sched, trace):
    """Run ``sched`` over ``trace`` tick by tick, a synchronizing host
    clock around each ``step()``.  Returns the report and the wall
    figures: total seconds, per-request latency (start of its arrival
    tick to end of its finishing tick) and the share of ticks the tier's
    modeled I/O, not the compute ceiling, priced."""
    import numpy as np

    sched.submit(trace)
    starts, ends, tier_ticks = [], [], 0
    quantum = 1.0 / sched.sys.cap_tok_s
    more = True
    while more:
        _sync(torch, sched.device)
        before = sched.model_time_s
        starts.append(time.perf_counter())
        more = sched.step()
        _sync(torch, sched.device)
        ends.append(time.perf_counter())
        # a tick costs max(quantum, tier I/O): above the quantum (past
        # the float sum's rounding) the tier priced it
        tier_ticks += (sched.model_time_s - before) > quantum * (1 + 1e-9)
    rep = sched.report()
    lat = [ends[r.finish_step] - starts[int(np.ceil(r.arrival))]
           for r in rep.records]
    return rep, dict(wall_s=ends[-1] - starts[0], latency_s=lat,
                     tier_tick_share=tier_ticks / len(starts))


def _wall_line(rep, wall) -> str:
    import numpy as np

    lat = wall["latency_s"]
    return (f"wall {wall['wall_s']:.3f} s, {rep.decode_tokens / wall['wall_s']:.3f}"
            f" tok/s, request latency p50 {np.percentile(lat, 50):.3f} s p99 "
            f"{np.percentile(lat, 99):.3f} s")


def sched_path(torch, build, cfg, params, dev, trace_kw=SCHED_TRACE,
               engine_kw=SCHED_ENGINE):
    """[sched]: the continuous-batching scheduler at full width in four
    cases, launch counts set to 0 just before each and read just after:
    (a) prefix share, no ladder — tokens equal solo runs, the shared
    windows bit-identical to a follower's own, queue delay and an
    admission discount; (b) a with the default ladder — every spilled page
    of this trace is a shared prompt page, which reclaim never touches, so
    it frees 0 B and keeps a's tokens; (c) the ladder without prefix share,
    so private pages can shed planes (reclaims > 0 B); (d) c on 4
    hash-stripe shards — c's tokens and reclaimed bytes.  After each case
    the tier is empty.  Returns the summed launches."""
    import numpy as np

    from repro_torch.core.synth import request_trace
    from repro_torch.runtime import (
        DEFAULT_DEGRADE_LADDER, PAPER_POLICY, ServeEngine, ServeScheduler,
        projected_kv_bytes,
    )

    trace = request_trace(vocab=cfg.vocab, **trace_kw)
    total = trace_kw["prompt_len"] + trace_kw["new_tokens"]
    proj = projected_kv_bytes(cfg, 1, total, engine_kw["page_tokens"])
    cap = int(CAPACITY_PROJECTIONS * proj)
    print(f"[sched] {len(trace)} requests arriving at ticks "
          f"{[int(np.ceil(r['arrival'])) for r in trace]}, "
          f"{trace_kw['prompt_len']} + {trace_kw['new_tokens']} tokens, "
          f"the first {trace_kw['share_prefix_len']} shared; projection "
          f"{proj} B a request; kv capacity {cap} B "
          f"({CAPACITY_PROJECTIONS} projections, physical model)",
          flush=True)
    cases = {
        "a share": dict(prefix_share=True),
        "b share + ladder": dict(prefix_share=True,
                                 degrade_ladder=DEFAULT_DEGRADE_LADDER),
        "c ladder": dict(degrade_ladder=DEFAULT_DEGRADE_LADDER),
        "d c on 4 shards": dict(degrade_ladder=DEFAULT_DEGRADE_LADDER,
                                shards=4, placement="hash-stripe"),
    }
    reps, total_launches = {}, {name: 0 for name in build.KERNELS}
    solo = None
    for case, extra in cases.items():
        sched = ServeScheduler(
            cfg, params, max_batch=3, device_kind="trace",
            policy=PAPER_POLICY, kv_capacity_bytes=cap,
            capacity_model="physical", device=dev, **engine_kw, **extra)
        probe = SharedWindowProbe(torch, ServeEngine) \
            if case.startswith("a") else None
        build.reset_launches()
        try:
            rep, wall = drive_scheduler(torch, sched, trace)
        finally:
            if probe is not None:
                probe.restore()
        launches = dict(build.LAUNCHES)
        check_serving_launches(f"[sched] {case}", launches)
        for name in total_launches:
            total_launches[name] += launches[name]
        _tier_empty(f"[sched] {case}", sched.tier)
        for r in rep.records:
            t = r.tokens
            if t.shape != (1, trace_kw["new_tokens"]) or t.min() < 0 \
                    or t.max() >= cfg.vocab:
                raise AssertionError(f"[sched] {case}: bad tokens {t.shape}")
        if solo is None:
            solo = [_solo_tokens(cfg, params, dev, engine_kw, sched.max_seq,
                                 r["prompt"], r["max_new_tokens"], r["seed"])
                    for r in trace]
        same_solo = all(np_equal(s, r.tokens)
                        for s, r in zip(solo, rep.records))
        proj_sum = sum(r.kv_projected_bytes for r in rep.records)
        charged = sum(r.kv_charged_bytes for r in rep.records)
        print(f"[sched] {case}: {rep.steps} ticks, peak batch "
              f"{rep.peak_active}; {_wall_line(rep, wall)}; modeled "
              f"{rep.model_time_s * 1e3:.2f} ms, {rep.tok_s:.2f} tok/s, "
              f"latency p50 {rep.p50_latency_s * 1e3:.2f} ms p99 "
              f"{rep.p99_latency_s * 1e3:.2f} ms, mean queue delay "
              f"{rep.mean_queue_delay_s * 1e3:.2f} ms, TTFT p50 "
              f"{rep.p50_ttft_s * 1e3:.2f} ms, tier-bound ticks "
              f"{wall['tier_tick_share']:.4f}; ratio estimate "
              f"{rep.kv_ratio_estimate:.4f}, reclaimed {rep.reclaimed_bytes}"
              f" B, admission charged {charged} of {proj_sum} B projected; "
              f"admit/finish ticks "
              f"{[(r.admit_step, r.finish_step) for r in rep.records]}; "
              f"tokens == solo runs: {same_solo}; launches {launches}",
              flush=True)
        reps[case] = rep
        if case.startswith("a"):
            if not same_solo:
                raise AssertionError("[sched] a: tokens differ from solo runs")
            if probe.checked == 0 or probe.mismatched:
                raise AssertionError(
                    f"[sched] a: shared windows: {probe.checked} checked, "
                    f"{probe.mismatched} differ from the follower's own")
            if not rep.mean_queue_delay_s > 0:
                raise AssertionError("[sched] a: no request waited")
            if not charged < proj_sum:
                raise AssertionError("[sched] a: no admission discount")
            print(f"[sched] a: {probe.checked} shared pages acquired at a "
                  f"follower's prefill read back at FULL bit-identical to "
                  f"the follower's own cache windows", flush=True)
    a, b, c, d = reps.values()
    if b.reclaimed_bytes != 0 or not all(
            np_equal(x.tokens, y.tokens) for x, y in zip(a.records, b.records)):
        raise AssertionError("[sched] b: the ladder touched a shared page or "
                             "changed a's tokens")
    if not c.reclaimed_bytes > 0:
        raise AssertionError("[sched] c: the ladder reclaimed nothing")
    if d.reclaimed_bytes != c.reclaimed_bytes or not all(
            np_equal(x.tokens, y.tokens) for x, y in zip(c.records, d.records)):
        raise AssertionError("[sched] d: 4 shards changed c's tokens or "
                             "reclaimed bytes")
    print(f"[sched] b reclaimed 0 B with a's tokens; c reclaimed "
          f"{c.reclaimed_bytes} B; d == c tokens and reclaimed bytes",
          flush=True)
    return total_launches


def streams_path(torch, build, cfg, params, dev, trace_kw=SCHED_TRACE,
                 engine_kw=SCHED_ENGINE, n_streams=2):
    """[streams]: ``n_streams`` sequences through one MultiStreamEngine at
    [sched]'s lengths, launch counts set to 0 just before and read just
    after; each stream's tokens equal its solo run, the tier empty after.
    Per-stream wall latency: start to the end of its last decode."""
    import numpy as np

    from repro_torch.runtime import PAPER_POLICY, MultiStreamEngine

    n_new, prompt_len = trace_kw["new_tokens"], trace_kw["prompt_len"]
    max_seq = prompt_len + n_new + engine_kw["page_tokens"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (1, prompt_len)).astype(np.int32)
               for _ in range(n_streams)]
    multi = MultiStreamEngine(cfg, params, n_streams, device_kind="trace",
                              max_seq=max_seq, batch=1, policy=PAPER_POLICY,
                              device=dev, **engine_kw)
    last = [0.0] * n_streams

    def stamped(i, decode):
        def run(tokens):
            out = decode(tokens)          # logits on the host: synced
            last[i] = time.perf_counter()
            return out
        return run

    for i, eng in enumerate(multi.streams):
        eng.decode = stamped(i, eng.decode)
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    toks = multi.generate(prompts, n_new)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check_serving_launches("[streams]", launches)
    d = multi.device_stats()
    multi.retire()
    _tier_empty("[streams]", multi.tier)
    same = [np_equal(t, _solo_tokens(cfg, params, dev, engine_kw, max_seq, p,
                                     n_new, i))
            for i, (t, p) in enumerate(zip(toks, prompts))]
    lat = [t - t0 for t in last]
    print(f"[streams] {n_streams} streams x ({prompt_len} + {n_new}) tokens: "
          f"wall {wall:.3f} s, {n_streams * n_new / wall:.3f} tok/s, stream "
          f"latency p50 {np.percentile(lat, 50):.3f} s p99 "
          f"{np.percentile(lat, 99):.3f} s; shared tier link out "
          f"{d.link_bytes_out} B, DRAM read {d.dram_bytes_read} B; "
          f"tokens == solo runs: {same}; launches {launches}", flush=True)
    if not all(same):
        raise AssertionError("[streams] a stream's tokens differ from its "
                             "solo run")
    return launches


# [weights]: the weight stream of qwen2-0.5b at full width through a trace
# tier on the card.  Every decoder matrix of every layer is a unit at its
# real shape; a unit's importance falls with its layer.
WEIGHT_MATS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
               ("attn", "wo"), ("mlp", "w1"), ("mlp", "w3"), ("mlp", "w2"))
WEIGHT_LAYERS = 24           # every decoder layer
FLEET_LAYERS = 4             # the replicate-weights fleet's share
FLEET_SHARDS = 4
BLOCK_ELEMS = 2048           # core.bitplane.BLOCK_ELEMS: a 4 KB block


# Host functions whose cumulative time splits the weight path (cProfile).
_WEIGHT_LOAD_SPANS = (
    ("put_many", "runtime/weights.py", "put_many"),
    ("  units to host", "runtime/weights.py", "_bf16_words"),
    ("  blocks staged", "core/tier.py", "_stage_write"),
    ("  pack on card", "kernels/bitplane.py", "pack_planes_slab"),
    ("  codec", "core/codec.py", "compress_slab"),
    ("    pre-screen (host)", "core/codec.py", "_prescreen_slab"),
    ("    LZ4 prep + match on card", "kernels/lz4.py", "lz4_match"),
    ("    LZ4 emit (host)", "core/codec.py", "lz4_emit_events"),
    ("  blocks committed", "core/tier.py", "_commit"),
)
_WEIGHT_FETCH_SPANS = (
    ("fetch_all", "runtime/weights.py", "fetch_all"),
    ("  LZ4 decompress (host)", "core/codec.py", "decompress_batch"),
    ("  unpack + round on card", "core/tier.py", "_decode_planes"),
    ("  units assembled", "core/tier.py", "_assemble"),
    ("  words to card", "runtime/weights.py", "_tensor"),
)


def _spans(stats, spans) -> str:
    """``label seconds`` of each span's cumulative time in ``stats``."""
    parts = []
    for label, path, fn in spans:
        ct = sum(v[3] for k, v in stats.items()
                 if k[2] == fn and k[0].endswith(path))
        parts.append(f"{label} {ct:.3f}")
    return "; ".join(parts)


def _allocated(torch, dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _peak(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def weight_units(params, layers: int) -> dict:
    """``L{layer}.{matrix}`` -> (bf16 weight on the card, importance)."""
    n = len(params["layers"]["attn"]["wq"])
    return {f"L{l}.{m}": (params["layers"][g][m][l], float(n - l))
            for l in range(layers) for g, m in WEIGHT_MATS}


def _block_sizes(numel: int) -> list:
    """A tensor's blocks (the tail block is zero-padded to full size)."""
    return [BLOCK_ELEMS] * -(-numel // BLOCK_ELEMS)


def _slabs(sizes, cap: int) -> int:
    """Slabs the tier cuts a block list into (a new slab whenever the
    next block would pass ``cap``)."""
    n, cur = 0, 0
    for s in sizes:
        if cur and cur + s > cap:
            n, cur = n + 1, 0
        cur += s
    return n + (cur > 0)


def fetched_mask(view) -> int:
    return sum(1 << p for p in view.fetched_planes())


class Recorder:
    """Every receipt a tier's ``submit`` returns."""

    def __init__(self, tier):
        self.recs, submit = [], tier.submit

        def wrapped(reqs):
            out = submit(reqs)
            self.recs.extend(out)
            return out
        tier.submit = wrapped


def _receipt_fields(rec) -> dict:
    return {k: v for k, v in vars(rec).items() if k not in ("data", "gather")}


def check_weight_words(torch, k_bitplane, ws, units, out, tag):
    """Every fetched unit equals its source words' fetched planes rounded
    to its view (``view_round_plain``, on the card); FULL units equal the
    params bit for bit."""
    n_full = 0
    for name, (w, _) in units.items():
        view = ws.view_for(name)
        src = w.contiguous().view(torch.int16).reshape(-1).to(torch.int32)
        want = k_bitplane.to_int16(k_bitplane.view_round_plain(
            (src & 0xFFFF) & fetched_mask(view),
            k_bitplane.view_round_params(view)))
        got = out[name]
        if got.shape != w.shape or got.dtype != torch.bfloat16 \
                or got.device != w.device:
            raise AssertionError(f"{tag}: {name} came back {got.dtype} "
                                 f"{tuple(got.shape)} on {got.device}")
        if not torch.equal(got.view(torch.int16).reshape(-1), want):
            raise AssertionError(f"{tag}: {name} at {view.name} differs "
                                 "from view_round_plain of its source")
        if view.is_full:
            n_full += 1
            if not torch.equal(got.view(torch.int16), w.view(torch.int16)):
                raise AssertionError(f"{tag}: FULL unit {name} is not the "
                                     "params bit for bit")
    return n_full


def weights_path(torch, build, k_bitplane, k_lz4, serve, params, dev,
                 layers: int = WEIGHT_LAYERS,
                 fleet_layers: int = FLEET_LAYERS):
    """Load and fetch the decoder weights through a ``WeightStore`` on the
    card, with the launch counts set to 0 just before each and read just
    after; hold the words, the CPU tier's bytes and a replicate-weights
    fleet to the single device; serve one request on that fleet."""
    import numpy as np

    from repro_torch.core.tier import ReadReq, make_device
    from repro_torch.runtime import WeightStore

    units = weight_units(params, layers)
    n_elems = sum(w.numel() for w, _ in units.values())
    sizes = [s for w, _ in units.values() for s in _block_sizes(w.numel())]
    enc_slabs = _slabs(sizes, SLAB_ELEMS)

    # -- load: one put_many -------------------------------------------------
    ws = WeightStore("trace", device=dev)
    prep_calls = ShapeRecorder(k_lz4, "lz4_prep",
                               lambda buf, runb=True: f"runb={runb}")
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    try:
        ws.put_many(units)
        _sync(torch, dev)
    finally:
        k_lz4.lz4_prep = prep_calls.original
    load_s = time.perf_counter() - t0
    load = dict(build.LAUNCHES)
    stats = ws.stats
    if stats.raw_bytes_stored != 2 * n_elems:
        raise AssertionError(f"stored {stats.raw_bytes_stored} logical bytes "
                             f"of {2 * n_elems}")
    if load["bitplane_pack"] != enc_slabs:
        raise AssertionError(f"{load['bitplane_pack']} pack launches for "
                             f"{enc_slabs} encode slabs")
    if not 0 < load["lz4_match"] == load["lz4_prep"] <= enc_slabs:
        raise AssertionError(f"load: prep {load['lz4_prep']} / match "
                             f"{load['lz4_match']} for {enc_slabs} slabs")
    if prep_calls.counts != {"runb=False": load["lz4_prep"]}:
        raise AssertionError(f"load: prep calls {prep_calls.counts}")
    for name in ("kv_delta_fwd", "kv_delta_inv", "bitplane_unpack",
                 "decode_attn", "pnm_score", "elastic_matmul"):
        if load[name]:
            raise AssertionError(f"load launched {name}: {load}")

    # -- fetch: one fetch_all at the policy's views --------------------------
    alone = ShapeRecorder(k_bitplane, "unpack_planes",
                          lambda rows, *a, **kw: rows.shape[1] * 8)
    groups: dict = {}
    for name, (w, _) in units.items():
        groups.setdefault(ws.view_for(name), []).extend(
            _block_sizes(w.numel()))
    dec_slabs = sum(_slabs(g, DECODE_ELEMS) for g in groups.values())
    stats.reset_traffic()
    build.reset_launches()
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    held = _allocated(torch, dev)
    t0 = time.perf_counter()
    try:
        out = ws.fetch_all()
        _sync(torch, dev)
    finally:
        k_bitplane.unpack_planes = alone.original
    fetch_s = time.perf_counter() - t0
    # the decoded slabs do not stay on the card: at most the words the
    # fetch returns there, and one slab's temporaries, above what was held
    peak = _peak(torch, dev) - held
    if peak > 2 * n_elems + (256 << 20):
        raise AssertionError(f"fetch_all held {peak} B on the card for "
                             f"{2 * n_elems} B of words")
    fetch = dict(build.LAUNCHES)
    n_alone = sum(alone.counts.values())
    trace_read = stats.dram_bytes_read
    if n_alone != dec_slabs or fetch["bitplane_unpack"] != n_alone:
        raise AssertionError(f"fetch: {n_alone} standalone unpack launches "
                             f"({fetch['bitplane_unpack']} counted) for "
                             f"{dec_slabs} decode slabs")
    for name in ("kv_delta_fwd", "kv_delta_inv", "elastic_matmul",
                 "bitplane_pack", "lz4_prep", "lz4_match"):
        if fetch[name]:
            raise AssertionError(f"fetch launched {name}: {fetch}")
    n_full = check_weight_words(torch, k_bitplane, ws, units, out, "[weights]")
    mix = {v.name: sum(1 for n in units if ws.view_for(n) == v)
           for v in groups}
    del out

    # -- the same units on a plain (word) device: the DRAM read ratio -------
    plain = WeightStore("plain", device=dev)
    plain.put_many(units)
    plain.stats.reset_traffic()
    pout = plain.fetch_all()
    for name, (w, _) in units.items():
        view = plain.view_for(name)
        src = w.contiguous().view(torch.int16).reshape(-1).to(torch.int32)
        want = k_bitplane.to_int16(k_bitplane.view_round_plain(
            src & 0xFFFF, k_bitplane.view_round_params(view)))
        if not torch.equal(pout[name].view(torch.int16).reshape(-1), want):
            raise AssertionError(f"plain store: {name} is not its words "
                                 f"rounded to {view.name}")
    plain_read = plain.stats.dram_bytes_read
    del pout, plain

    # -- layer 0 through a CPU tier: bytes, flags and receipts; where the
    # card store's load and fetch time goes (cProfile) ----------------------
    import cProfile
    import pstats

    layer0 = {k: v for k, v in units.items() if k.startswith("L0.")}
    tiers = {}
    for where in (dev, torch.device("cpu")):
        store = WeightStore("trace", device=where)
        rec = Recorder(store.tier)
        prof = cProfile.Profile()
        prof.enable()
        store.put_many({k: (w.to(where), imp)
                        for k, (w, imp) in layer0.items()})
        _sync(torch, where)
        prof.disable()
        tiers[where.type] = (store.tier,
                             [_receipt_fields(r) for r in rec.recs])
        if where == dev:
            l0_load = pstats.Stats(prof).stats
            prof = cProfile.Profile()
            prof.enable()
            store.fetch_all()
            _sync(torch, where)
            prof.disable()
            l0_fetch = pstats.Stats(prof).stats
    (card, crecs), (cpu, precs) = tiers[dev.type], tiers["cpu"]
    if crecs != precs:
        raise AssertionError("layer 0: card receipts differ from the CPU's")
    for key, blocks in cpu._tensors.items():
        if [(b.payloads, b.flags) for b in card._tensors[key]] != \
                [(b.payloads, b.flags) for b in blocks]:
            raise AssertionError(f"layer 0: {key}'s stored bytes differ "
                                 "card vs CPU")
    l0_stored = card.stats.dram_bytes_stored
    del tiers, card, cpu

    ratio = stats.raw_bytes_stored / stats.dram_bytes_stored
    print(f"[weights] {len(units)} units of {layers} layers, {n_elems} "
          f"elements ({2 * n_elems} B bf16) in one put_many: stored "
          f"{stats.dram_bytes_stored} B, weight compression ratio "
          f"{ratio:.4f} (logical / stored), codec bypass "
          f"{stats.bypass_rate:.4f} of {stats.codec_blocks} plane streams; "
          f"avg_bits {ws.avg_bits():.2f} (units per view {mix}); load "
          f"{load_s:.3f} s, fetch_all {fetch_s:.3f} s wall (synchronizing "
          "host clock)", flush=True)
    print(f"[weights] fetch_all DRAM read: trace {trace_read} B, plain "
          f"{plain_read} B, trace / plain {trace_read / plain_read:.4f}",
          flush=True)
    print(f"[weights] launches: load {load} over {enc_slabs} encode slabs; "
          f"fetch {fetch}; standalone unpack {n_alone} launches over "
          f"{dec_slabs} decode slabs (elements a launch: "
          f"{dict(sorted(alone.counts.items()))})", flush=True)
    print(f"[weights] every unit == view_round_plain of its source on the "
          f"card ({n_full} FULL units == params bit for bit); plain store "
          f"words == its views' round of the source; layer 0 (7 units, "
          f"{l0_stored} B stored): card receipts, bytes and flags == CPU; "
          f"fetch_all held {peak} B on the card above its start "
          f"({2 * n_elems} B of words returned there)", flush=True)
    print("[profile] layer 0's load on the card under cProfile: "
          + _spans(l0_load, _WEIGHT_LOAD_SPANS) + "; its fetch_all: "
          + _spans(l0_fetch, _WEIGHT_FETCH_SPANS) + " (s, cumulative)",
          flush=True)

    # -- the standalone unpack at a weight's decode slab ---------------------
    w1 = units["L0.w1"][0].contiguous().view(torch.int16).reshape(-1)
    planes = k_bitplane.pack_planes_u16(w1[:DECODE_ELEMS])
    times, row = {}, None
    for view in sorted(groups, key=lambda v: -v.bits):
        ids = view.fetched_planes()
        rows = planes[list(ids)].contiguous()
        rnd = k_bitplane.view_round_params(view)
        got = k_bitplane.unpack_planes(rows, ids, view)
        want = k_bitplane.unpack_planes_plain(rows, ids, rnd)
        err = float((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err:
            raise AssertionError(f"standalone unpack at {view.name} differs "
                                 f"from its plain version by {err}")
        t = timed(torch, lambda: k_bitplane.unpack_planes(rows, ids, view))
        b, by = bound_ms(len(ids) * DECODE_ELEMS // 8 + 2 * DECODE_ELEMS,
                         3 * len(ids) * DECODE_ELEMS)
        times[view.name] = (t["ms"], b)
        if row is None:     # the kernels line's row: the widest view
            row = dict(
                name="bitplane_unpack_planes", route="cuda",
                source="src/repro_torch/csrc/bitplane_unpack.cu",
                replaces="src/repro/kernels/bitplane.py:51",
                max_abs_err=err, **t,
                plain_ms=timed(torch, lambda: k_bitplane.unpack_planes_plain(
                    rows, ids, rnd))["ms"],
                bound_ms=b, bound_by=by, library_ms=None, view=view.name)
    print("[kernel] standalone unpack + round at a weight's decode slab "
          f"(w1 of layer 0, {DECODE_ELEMS} elements): " + "; ".join(
              f"{k} {ms * 1e3:.2f} us (bound {b * 1e3:.3f} us by bytes)"
              for k, (ms, b) in times.items()), flush=True)

    # -- replicate-weights: the first layers on every shard ------------------
    fl = {k: v for k, v in units.items()
          if int(k[1:k.index(".")]) < fleet_layers}
    fleet = make_device("trace", shards=FLEET_SHARDS,
                        placement="replicate-weights", window=2, device=dev)
    fws = WeightStore(fleet)
    fws.put_many(fl)
    fout = fws.fetch_all()
    # the single device's words at the fleet store's views (its units
    # rank among fewer, so their views differ from the full load's)
    single = {r.key: r.data.reshape(-1) for r in ws.tier.submit(
        [ReadReq(k, view=fws.view_for(k)) for k in fl])}
    for k in fl:
        if not np_equal(fout[k].view(torch.int16).cpu().numpy()
                        .view(np.uint16).reshape(-1), single[k]):
            raise AssertionError(f"replicate-weights: {k} differs from the "
                                 "single device's")
    want = sum(ws.tier.resident_bytes(f"L{l}") for l in range(fleet_layers))
    per_shard = [s.resident_bytes() for s in fleet.shards]
    if per_shard != [want] * FLEET_SHARDS:
        raise AssertionError(f"replicate-weights: shard bytes {per_shard}, "
                             f"single device {want}")
    del fout
    # per-unit reads through the async front-end: a window of 2 flushes
    # unwaited groups, so the next read finds another replica least busy
    fleet.quiesce()
    for s in fleet.shards:
        s.stats.reset_traffic()
    tickets = [t for k in fl for t in fleet.submit_async(
        [ReadReq(k, view=fws.view_for(k))])]
    recs = fleet.drain(tickets)
    split = [sum(1 for r in recs if r.device_id == i)
             for i in range(FLEET_SHARDS)]
    if sum(1 for n in split if n) < 2:
        raise AssertionError(f"replicate-weights reads did not spread: "
                             f"{split}")
    for r, k in zip(recs, fl):
        if not np_equal(r.data.reshape(-1), single[k]):
            raise AssertionError(f"replicate-weights: async read of {k} "
                                 "differs from the single device's")
    print(f"[weights] replicate-weights: {len(fl)} units of "
          f"{fleet_layers} layers on {FLEET_SHARDS} shards, words == the "
          f"single device's, every shard {want} B resident (== the single "
          f"device's); per-unit async reads split {split} over the shards "
          f"(DRAM read B {[s.stats.dram_bytes_read for s in fleet.shards]})",
          flush=True)
    del fleet, fws, single

    kw = dict(arch="qwen2-0.5b", smoke=False, device="trace", prompt_len=512,
              n_tokens=64, batch=1, requests=1, hbm_kv_budget=1 << 22,
              page_tokens=64, seed=0, torch_device=dev, params=params,
              verbose=False)
    solo = serve(**kw, shards=None)
    build.reset_launches()
    rep = serve(**kw, shards=FLEET_SHARDS, placement="replicate-weights")
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    check_serving_launches("replicate-weights request", launches)
    if not np_equal(rep.tokens[0], solo.tokens[0]):
        raise AssertionError("replicate-weights fleet changed the tokens")
    print(f"[weights] one request of 512 + 64 tokens on the "
          f"replicate-weights fleet: tokens == one device's; wall tok/s "
          f"{rep.tok_s:.3f} (one device {solo.tok_s:.3f}); launches "
          f"{launches}", flush=True)
    row["launches"] = n_alone
    return dict(load=load, fetch=fetch, standalone=n_alone,
                enc_slabs=enc_slabs, dec_slabs=dec_slabs, row=row)


def examples_path(torch, build, dev="cuda"):
    """Run the three example twins on the card, as ``python -m
    repro_torch.examples.<name>`` runs them without ``--cpu``: each one's
    own assertions, the tier kernels launched, and the quickstart's tier
    numbers equal to its run on the CPU (the model's are not compared:
    bf16 matmuls round at other places on the card)."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_async, serve_continuous

    twins = (("quickstart", quickstart), ("serve_async", serve_async),
             ("serve_continuous", serve_continuous))
    out = {}
    for name, mod in twins:
        argv = [] if dev == "cuda" else ["--cpu"]
        buf = io.StringIO()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        _sync(torch, torch.device(dev))
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[examples] {name} | {line}", flush=True)
        need = ("bitplane_pack", "lz4_prep", "lz4_match", "bitplane_unpack")
        if name != "quickstart":
            need += ("kv_delta_fwd", "decode_attn")
        if any(not launches[k] for k in need) or \
                launches["lz4_prep"] != launches["lz4_match"] or \
                launches["kv_delta_inv"] or launches["elastic_matmul"]:
            raise AssertionError(f"example {name} on the card launched "
                                 f"{launches}")
        print(f"[examples] {name} on {dev}: {wall:.3f} s wall, launches "
              f"{launches}", flush=True)
        out[name] = res
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = quickstart.main(["--cpu"])
    if cpu != out["quickstart"]:
        raise AssertionError(f"quickstart on the card {out['quickstart']} "
                             f"!= on the CPU {cpu}")
    print("[examples] quickstart's ratios, DRAM bytes and man4 error on the "
          "card == on the CPU", flush=True)
    return out


# the kernels only the kernel API reaches
API_ONLY_KERNELS = ("elastic_matmul", "kv_delta_inv")


def np_equal(x, y) -> bool:
    return x.shape == y.shape and bool((x == y).all())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


class ShapeRecorder:
    """Record the input shapes of ``module.name`` (which still runs) —
    how the main path batches a kernel's work — or, with ``key``, what
    ``key(*args, **kw)`` says of each call."""

    def __init__(self, module, name, key=None):
        self.original = getattr(module, name)
        self.counts = {}

        def wrapped(x, *args, **kw):
            k = key(x, *args, **kw) if key else "x".join(map(str, x.shape))
            self.counts[k] = self.counts.get(k, 0) + 1
            return self.original(x, *args, **kw)
        setattr(module, name, wrapped)


def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository: src/repro_torch is "
             "missing next to this script", 2)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs an "
             "NVIDIA GPU", 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    from repro_torch.kernels import bitplane as k_bitplane
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as k_attn
    from repro_torch.kernels import elastic_matmul as k_mm
    from repro_torch.kernels import kv_delta as k_kv
    from repro_torch.kernels import lz4 as k_lz4
    from repro_torch.kernels import ops
    from repro_torch.kernels import pnm_score as k_pnm
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def phase(name):
        print(f"[time] {name} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    results = {}
    check_kernels(torch, k_bitplane, k_lz4, k_attn, results)
    check_pnm_score(torch, k_pnm, results)
    check_kv_and_unpack(torch, build, k_bitplane, k_kv, results)
    check_lz4_match(torch, k_bitplane, k_kv, k_lz4, results)
    check_elastic_matmul(torch, k_bitplane, k_mm, ops, results)
    for r in results.values():
        lib = r["library_ms"]
        lib = "-" if lib is None else f"{lib * 1e3:.2f} us"
        print(f"[kernel] {r['name']}: {r['ms'] * 1e3:.2f} us device "
              f"({r['ms_from']}; {r['call_ms'] * 1e3:.2f} us per call "
              f"back to back), plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, library "
              f"{lib}; max abs err {r['max_abs_err']:.3g}", flush=True)
    phase("kernel checks")
    api_launches = kernel_api_path(torch, build, ops, k_mm)
    for name in API_ONLY_KERNELS:
        results[name]["launches"] = api_launches[name]
    phase("kernel API")
    diff = check_tier_and_model(torch)
    print(f"[check] tier encode, readback at every view and PNM gathers "
          f"cuda == cpu; the per-block encoder == the batched one on the "
          f"card; smoke-model "
          f"logits cuda vs cpu max |diff| {diff:.4g}", flush=True)
    phase("tier and model checks")

    params = init_params(ARCHS["qwen2-0.5b"], seed=0, device="cuda")
    fwd_shapes = ShapeRecorder(k_kv, "kv_forward")
    prep_calls = ShapeRecorder(k_lz4, "lz4_prep",
                               lambda buf, runb=True: f"runb={runb}")
    build.reset_launches()
    rep = serve(arch="qwen2-0.5b", smoke=False, device="trace",
                prompt_len=512, n_tokens=64, batch=1, requests=3,
                hbm_kv_budget=1 << 22, page_tokens=64, seed=0,
                torch_device="cuda", params=params)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for toks in rep.tokens:
        if toks.shape != (1, 64) or toks.min() < 0 or toks.max() >= VOCAB:
            raise AssertionError(f"bad generated tokens {toks.shape}")
    if rep.spilled_pages <= 0 or rep.readback_pages <= 0:
        raise AssertionError(f"no spill/readback: {rep.spilled_pages} "
                             f"spilled, {rep.readback_pages} read back")
    k_kv.kv_forward = fwd_shapes.original
    k_lz4.lz4_prep = prep_calls.original
    if prep_calls.counts != {"runb=False": launches["lz4_prep"]}:
        raise AssertionError(f"prep calls {prep_calls.counts} are not one "
                             "launch each without run flags")
    if f"{FLUSH_WINDOWS}x{WINDOW}x{CHANNELS}" not in fwd_shapes.counts:
        raise AssertionError(f"the [kernel] check's prefill flush is not one "
                             f"the main path ran: {fwd_shapes.counts}")
    check_serving_launches("main path", launches)
    for name in SERVING_KERNELS:
        results[name]["launches"] = launches[name]
    if launches["kv_delta_inv"]:
        raise AssertionError("the main path's KV read launched the "
                             "standalone inverse")
    print(f"[main] wall tok/s {rep.tok_s:.3f}; compression ratio "
          f"{rep.kv_compression_ratio:.4f}; spilled {rep.spilled_pages}, "
          f"read back {rep.readback_pages}; launches {launches}; KV "
          f"forward batches {fwd_shapes.counts}; prep calls "
          f"{prep_calls.counts}", flush=True)
    phase("main path")
    check_readback_helpers(torch, ARCHS["qwen2-0.5b"], params)
    phase("readback helpers")
    wl = weights_path(torch, build, k_bitplane, k_lz4, serve, params,
                      torch.device("cuda", 0))
    # the weight path's standalone unpack has a row of its own, timed at
    # a weight's decode slab; bitplane_unpack's row is [main]'s fused read
    results["bitplane_unpack_planes"] = wl["row"]
    print(f"[weights] launches per weight load (encode slabs "
          f"{wl['enc_slabs']}): bitplane_pack {wl['load']['bitplane_pack']}, "
          f"lz4_prep {wl['load']['lz4_prep']}, lz4_match "
          f"{wl['load']['lz4_match']}; per fetch_all (decode slabs "
          f"{wl['dec_slabs']}): standalone bitplane_unpack "
          f"{wl['standalone']} (the kernels line's bitplane_unpack_planes "
          f"row, timed at {wl['row']['view']}; bitplane_unpack's row is "
          f"[main]'s {launches['bitplane_unpack']} fused KV reads)",
          flush=True)
    phase("weights path")
    pnm_launches = pnm_path(torch, serve, build, params)
    results["pnm_score"]["launches"] = pnm_launches["pnm_score"]
    phase("PNM path")
    cfg, dev = ARCHS["qwen2-0.5b"], torch.device("cuda", 0)
    sched_path(torch, build, cfg, params, dev)
    phase("scheduler path")
    streams_path(torch, build, cfg, params, dev)
    phase("multi-stream path")
    examples_path(torch, build)
    phase("examples")
    profile_request(torch, serve, params)
    profile_request(torch, serve, params, device_time=False, pnm_topk=16,
                    importance="attention")
    phase("profile")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys}
                                  for n in build.KERNELS
                                  + ("bitplane_unpack_planes",)]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:   # any failed phase: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
