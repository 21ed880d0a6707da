"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it — pack, prep and page scoring bit-equal
   (page scoring also on ragged, empty, NaN and inf pages, on duplicate
   pages and on one page alone and inside a larger batch), decode
   attention within f32 tolerance for bf16 and fp8 caches — and time
   kernel, plain version and (for attention) PyTorch's
   ``scaled_dot_product_attention``;
3. check the card's tier encode and PNM gather against the CPU's on the
   same KV pages (receipts, scores, winners and bytes identical) and the
   card's model against the CPU's on a small input;
4. serve 3 requests (512 prompt + 64 new tokens) through full-width
   qwen2-0.5b with random weights, KV spilling to a ``trace`` tier, with
   the kernel launch counts set to 0 just before and read just after;
5. the PNM path at full width, one request per case, launch counts read
   per case: (a) classic readback, (b) a gather covering every candidate
   (tokens identical to a), (c) top-16 gathers with attention importance
   (fewer link bytes than a), (d) c on a 4-shard fleet (tokens identical
   to c);
6. profile one more classic request (host split from cProfile, device
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
ATOL, RTOL = 2e-5, 1e-5      # f32 summation-order tolerance (attention)
# Page scoring: kernel and plain version sum each dot in the same order
# and round each product once, so they agree bit for bit (tolerance 0).

# Main-path shapes: full-width qwen2-0.5b, 64-token pages, 512 + 64 tokens.
SLAB_ELEMS = 128 * 1024      # BitplaneLayout.ENCODE_SLAB_ELEMS
HEADS, KV_HEADS, HEAD_DIM = 14, 2, 64
MAX_SEQ, VALID_LEN = 512 + 64 + 64, 576
PAGES, PAGE_ROWS = 64, 64    # gather candidates per KV kind at prefill
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


def timed(torch, fn) -> dict:
    """``ms``: device time per call (profiler; CUDA events when the
    profiler sees no device work); ``call_ms``: CUDA-event time per call
    of back-to-back calls, which includes the host's launch cadence."""
    call = time_ms(torch, fn)
    dev = device_ms(torch, fn)
    return {"ms": call if dev is None else dev, "call_ms": call,
            "ms_from": "events" if dev is None else "profiler"}


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOPS_S * 1e3
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
    nbytes = PAGES * PAGE_ROWS * CHANNELS * 2 + CHANNELS * 4 + PAGES * 8
    b, by = bound_ms(nbytes, 2 * PAGES * PAGE_ROWS * CHANNELS)
    results["pnm_score"] = dict(
        name="pnm_score", route="cuda", source="src/repro_torch/csrc/pnm_score.cu",
        replaces="src/repro/kernels/pnm_score.py:66", max_abs_err=0.0,
        **timed(torch, lambda: k_pnm.page_scores(pages, full, digest)),
        plain_ms=timed(torch, lambda: k_pnm.page_scores_plain(
            pages, full, digest))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)


def check_kernels(torch, k_bitplane, k_lz4, k_attn, results):
    gen = torch.Generator(device="cuda").manual_seed(0)

    # -- bit-plane pack at one full encode slab --------------------------------
    x = kv_like(torch, SLAB_ELEMS, gen)
    got = k_bitplane.pack_planes_u16(x)
    want = k_bitplane.pack_planes_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("bitplane_pack differs from its plain version")
    b, by = bound_ms(4 * SLAB_ELEMS, 64 * SLAB_ELEMS)
    results["bitplane_pack"] = dict(
        name="bitplane_pack", route="cuda",
        source="src/repro_torch/csrc/bitplane_pack.cu",
        replaces="src/repro/kernels/bitplane.py:38",
        max_abs_err=0.0,
        **timed(torch, lambda: k_bitplane.pack_planes_u16(x)),
        plain_ms=timed(torch, lambda: k_bitplane.pack_planes_plain(x))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)

    # -- LZ4 prep over that slab's packed planes -------------------------------
    slab = got.reshape(-1)
    n = slab.numel()
    got3 = k_lz4.lz4_prep(slab)
    want3 = k_lz4.prep_plain(slab)
    torch.cuda.synchronize()
    for g, w, what in zip(got3, want3, ("w", "h", "runb")):
        if not torch.equal(g, w):
            raise AssertionError(f"lz4_prep {what} differs from its plain "
                                 "version")
    b, by = bound_ms(13 * n, 10 * n)
    results["lz4_prep"] = dict(
        name="lz4_prep", route="cuda", source="src/repro_torch/csrc/lz4_prep.cu",
        replaces="src/repro/kernels/lz4.py:486", max_abs_err=0.0,
        **timed(torch, lambda: k_lz4.lz4_prep(slab)),
        plain_ms=timed(torch, lambda: k_lz4.prep_plain(slab))["ms"],
        bound_ms=b, bound_by=by, library_ms=None)

    # -- decode attention: bf16 and fp8 caches ----------------------------------
    q = torch.randn((1, HEADS, HEAD_DIM), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((1, MAX_SEQ, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((1, MAX_SEQ, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    errs = []
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        kc, vc = k.to(dt), v.to(dt)
        for valid in (VALID_LEN, 1, 77):
            got = k_attn.decode_attention(q, kc, vc, valid)
            want = k_attn.decode_attention_plain(q, kc, vc, valid)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not bool((err <= ATOL + RTOL * want.abs()).all()):
                raise AssertionError(
                    f"decode_attn ({dt}, valid_len={valid}) max error "
                    f"{float(err.max())} beyond atol {ATOL} rtol {RTOL}")
            errs.append(float(err.max()))
    # library yardstick: SDPA over the same valid prefix, KV heads expanded
    # outside the timed call (the port never calls it)
    group = HEADS // KV_HEADS
    kx = k[:, :VALID_LEN].repeat_interleave(group, dim=2).transpose(1, 2)
    vx = v[:, :VALID_LEN].repeat_interleave(group, dim=2).transpose(1, 2)
    kx, vx = kx.contiguous(), vx.contiguous()
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = (2 * VALID_LEN * KV_HEADS * HEAD_DIM * 2 + HEADS * HEAD_DIM * 2
              + HEADS * HEAD_DIM * 4)
    b, by = bound_ms(nbytes, 4 * HEADS * VALID_LEN * HEAD_DIM)
    results["decode_attn"] = dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:36",
        max_abs_err=max(errs),
        **timed(torch, lambda: k_attn.decode_attention(q, k, v, VALID_LEN)),
        plain_ms=timed(torch, lambda: k_attn.decode_attention_plain(
            q, k, v, VALID_LEN))["ms"],
        bound_ms=b, bound_by=by,
        library_ms=timed(torch, lambda: sdpa(q4, kx, vx))["ms"])


def check_tier_and_model(torch):
    """The card's tier encode against the CPU's on the same KV pages, and
    the card's model against the CPU's on a small input."""
    import numpy as np

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core.precision import FULL, MAN0, MAN4
    from repro_torch.core.tier import (
        KV, GatherReq, ReadReq, WriteReq, make_device,
    )
    from repro_torch.models.model import decode_step, init_cache, init_params

    rng = np.random.default_rng(1)
    pages = [(rng.standard_normal((64, CHANNELS)) * 0.5)
             .astype(np.float32) for _ in range(24)]
    u16 = [(p.view(np.uint32) >> 16).astype(np.uint16) for p in pages]
    writes = [WriteReq(f"p{i}", u, kind=KV) for i, u in enumerate(u16)]
    reads = [ReadReq(f"p{i}", kind=KV, view=v)
             for i in range(len(u16)) for v in (FULL, MAN4, MAN0)]
    out = {}
    for dev in ("cuda", "cpu"):
        tier = make_device("trace", device=dev)
        recs = tier.submit(writes) + tier.submit(reads)
        out[dev] = recs
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
                                for k in (0, 5, 24)])
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


# Host functions whose cumulative time splits one served request.
_SPANS = (
    ("prefill", "runtime/serving.py", "prefill"),
    ("decode steps", "runtime/serving.py", "decode"),
    ("model forward", "models/model.py", "decode_step"),
    ("cache windows to host", "runtime/serving.py", "_commit_pages"),
    ("tier encode", "core/tier.py", "_encode_commit"),
    ("  LZ4 match on card", "kernels/lz4.py", "_match_events_device"),
    ("  LZ4 emit (host)", "core/codec.py", "lz4_emit_events"),
    ("tier decode", "core/tier.py", "_do_reads"),
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
    print(f"[profile] one request under torch.profiler: wall "
          f"{rep.wall_s:.3f} s, device busy {busy_s:.3f} s "
          f"({100 * busy_s / rep.wall_s:.1f}%), {sum(n for *_, n in evts)} "
          f"kernels; top: "
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
    reps, total = {}, {name: 0 for name in build.SOURCES}
    for case, extra in cases.items():
        build.reset_launches()
        rep = serve(**kw, **extra)
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
          f"over b-d ({total['pnm_score']} in {tokens} tokens)", flush=True)
    return total


def np_equal(x, y) -> bool:
    return x.shape == y.shape and bool((x == y).all())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


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
    from repro_torch.kernels import lz4 as k_lz4
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
    for r in results.values():
        lib = r["library_ms"]
        lib = "-" if lib is None else f"{lib * 1e3:.2f} us"
        print(f"[kernel] {r['name']}: {r['ms'] * 1e3:.2f} us device "
              f"({r['ms_from']}; {r['call_ms'] * 1e3:.2f} us per call "
              f"back to back), plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, library "
              f"{lib}; max abs err {r['max_abs_err']:.3g}", flush=True)
    phase("kernel checks")
    diff = check_tier_and_model(torch)
    print(f"[check] tier encode and PNM gather cuda == cpu; smoke-model "
          f"logits cuda vs cpu max |diff| {diff:.4g}", flush=True)
    phase("tier and model checks")

    params = init_params(ARCHS["qwen2-0.5b"], seed=0, device="cuda")
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
    main_kernels = ("bitplane_pack", "lz4_prep", "decode_attn")
    for name in main_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
        results[name]["launches"] = launches[name]
    print(f"[main] wall tok/s {rep.tok_s:.3f}; compression ratio "
          f"{rep.kv_compression_ratio:.4f}; spilled {rep.spilled_pages}, "
          f"read back {rep.readback_pages}; launches {launches}", flush=True)
    phase("main path")
    pnm_launches = pnm_path(torch, serve, build, params)
    for name in build.SOURCES:
        if name not in main_kernels:
            results[name]["launches"] = pnm_launches[name]
    phase("PNM path")
    profile_request(torch, serve, params)
    profile_request(torch, serve, params, device_time=False, pnm_topk=16,
                    importance="attention")
    phase("profile")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys}
                                  for n in build.SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:   # any failed phase: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
