"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together; the checks of phase 2
   run while they compile, each waiting for its own library);
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
   and from a cold L2 cache; the KV forward, the fused read (at every
   view) and page scoring at deepseek-v2-lite-16b's 512-channel latent
   (48 windows or pages of 64 tokens, a 2-window decode slab); decode
   attention at llava-next-34b's shape (56 query heads over 8 KV heads,
   hd 128, 576 of 640 positions) beside its plain version, its bound and
   the fastest SDPA backend, and at 4096 and 32768 cached positions, the elastic matmul at
   each view beside its byte bound, the fused KV read beside the
   two-launch chain it replaces, and the match launch beside the wrapper
   (prep + match + one copy back) and the plain pipeline it replaces;
   decode attention's device-length entry (the captured decode step's:
   the length a 0-d int32 on the card) at [main]'s, llava-next-34b's and
   the decode_32k cell's shapes, at valid_len 1, a block boundary and
   the capacity (and 576 at [main]'s), against its plain version,
   bit-equal across two calls and to a CUDA graph's replay, timed beside
   the host-length entry (row ``decode_attn_devlen``).  A time the
   profiler did not see is printed as a CUDA-event time, never as a
   device time;
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
   input (qwen2-0.5b, stablelm-12b's layernorm, nemotron-4-340b's
   squared ReLU at smoke width);
5. serve 3 requests (512 prompt + 64 new tokens) through full-width
   qwen2-0.5b with random weights, KV spilling to a ``trace`` tier, each
   engine's decode step captured once in a CUDA graph and replayed every
   token (every serving phase below decodes so: decode attention's
   host-length entry must not launch), with
   the kernel launch counts set to 0 just before and read just after
   (the KV read goes through the fused kernel alone: the standalone
   inverse must not launch; every flush launches the prep, without run
   flags, and the match kernel once each);
   then (``[graph]``) one more such request: (a) every replay's logits
   bit-equal to ``decode_step`` run eagerly at the same tensor position on
   a copy of the cache (readback written between replays included), (b)
   the same tokens teacher-forced through the eager step at host int
   positions within the margin-aware bound, (c) wall tok/s, and the
   device's busy share and kernels under ``torch.profiler``, beside PR
   25's eager step, with the capture's seconds;
   then ``kv_through_tier`` of every layer's K and V and ``layer_traffic``
   of one more such request equal a CPU pool's fed its page stream;
6. the weight stream at full width (``[weights]``): the 14 decoder
   matrices of qwen2-0.5b's first 2 layers (of 24: a depth cut for
   the time limit; wq, wk, wv, wo, w1, w3, w2 at their real shapes,
   importance falling with the layer) loaded by one
   ``WeightStore.put_many`` into a ``trace`` tier on the card (a pack,
   a prep without run flags and a match launch per 128 Ki-element encode
   slab) and read back by one ``fetch_all`` at the ``DEFAULT_TIERS``
   views (a standalone unpack + round launch per 64 Ki-element decode
   slab; no KV kernel, no matmul): every unit equal to
   ``view_round_plain`` of its source's fetched planes, FULL units the
   params bit for bit; the same units on a ``plain`` device for the DRAM
   read ratio; layer 0 through a CPU tier, bytes, flags and receipts
   equal, and its load and fetch on the card split by host span
   (``SpanTimer``); the standalone unpack held to its plain version and
   timed at a weight's decode slab at each view (its own row in the
   ``kernels`` line, apart from the fused KV read's
   ``bitplane_unpack``); the first layer on a 4-shard
   ``replicate-weights`` fleet (words and per-shard bytes the single
   device's, async reads spread over the replicas) and one request of
   512 + 64 tokens served on that fleet (tokens equal one device's);
7. the PNM path at full width, one request per case, launch counts read
   per case: (a) classic readback, (b) a gather covering every candidate
   (tokens identical to a), (c) top-16 gathers with attention importance
   (fewer link bytes than a), (d) c on a 4-shard fleet (tokens identical
   to c), with the page-scoring wrapper's wall time per gather;
8. continuous batching at full width (``[sched]``; the first 6 of the
   24 layers, a depth cut for the time limit, with a 1 MiB HBM budget
   a request): six requests of
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
9. two streams through ``MultiStreamEngine`` (``[streams]``; [sched]'s
   6 layers and 1 MiB budget, a depth cut for the time limit), each
   stream's tokens equal to its solo run;
10. the four example twins (``repro_torch.examples``: quickstart,
   serve_async, serve_continuous, serve_elastic) on the card, as run
   without ``--cpu``: their own assertions, the tier kernels launched,
   the quickstart's numbers equal to its CPU run, serve_elastic's
   lossless policy agreeing with itself and its DRAM reads falling to
   the aggressive policy;
11. deepseek-v2-lite-16b at full width (``[mla]``: d 2048, MLA with a
   512-channel latent, 64 routed experts top-6 + 2 shared, the dense
   first layer; its depth cut to 9 of 27 layers and its HBM budget to
   1 MiB, so 48 of its 64 prompt pages spill; random bf16 weights drawn
   on the card), its
   ``c_kv`` pages through the tier in five serve runs, launch counts
   read per run: (a) two classic requests, (b) a covering gather (tokens
   == a's), (c) top-16 gathers with attention importance, (d) the
   lossless policy with spills (tokens == an unspilled run); KV forward,
   pack, prep, match and the fused read launch in each, page scoring in
   b and c, decode attention never (MLA attends in eager PyTorch); one
   flush of c_kv pages on the card's tier == the CPU's; decode ==
   forward at the prompt's last position with every routing decision
   pinned to the forward's (flips only at bf16 near-ties); one request's
   host spans; the params freed (the KV forward, the fused read
   and page scoring at these 512-channel shapes are checked and timed
   in phase 2, rows ``*_latent``; [mla] checks it ran those shapes);
12. the recurrent families at full width (``[ssm]``, random bf16
   weights from seed 0 drawn on the card, freed after each; the depth
   cut for the time limit, every op still run — to 8 layers each for
   the [dryrun] phase, from 12 for [mesh] and 16 / 18 before): (a)
   falcon-mamba-7b (8 of its 64 Mamba1 layers) and (b) zamba2-7b (8 of
   its 81 Mamba2 layers and one shared windowed attention block applied
   once of its 13 times)
   each serve one request of 512 + 64 tokens with the
   launch counts set to 0 just before and read just after — no page
   spilled, no kernel launched (the state pages nothing; the hybrid's
   rolling cache attends in plain PyTorch), nothing stored — then
   decode == forward over the served sequence (and the served tokens its
   greedy choices), for (b) its prefill through the cache == its forward
   and the shared block's applications counted, and one full-width
   layer's mixer on the card against the CPU; (c) zamba2's layer-0
   ``in_proj`` (3584 x 14496) as 4 units through a ``WeightStore`` on
   the card and on a CPU tier: payloads, flags, receipts, stats and
   words identical, every unit its source rounded to its view, the
   pack / prep / match / standalone-unpack launches counted;
13. the embeds-fed models (``[frontends]``): hubert-xlarge at full width
   and depth (one forward of 512 seeded frame embeds without a cache,
   one full-width layer card vs CPU) and llava-next-34b at full width,
   its depth cut to 4 of 60 layers (68 GB of bf16 parameters and their
   f32 draw do not fit): a 512-embed prompt, then 64 teacher-forced
   embed steps, decode == forward, decode attention launched once a
   layer a step at its shape (row ``decode_attn_llava``);
14. training on the card (``[train]``; no kernel of the port may
   launch, counts set to 0 before each part and read after), each
   ``train`` run's step captured once as a CUDA graph at its second
   step, after its eager first step (``TrainGraph``), and replayed at it
   and every later step: (a)
   qwen2-0.5b at full width and depth (24 layers, 494 M random bf16
   parameters from seed 0, remat on) takes 4 steps of ``train`` at
   TRAIN_4K's 4096 tokens x a global batch of 2 (cut from 256), grad
   compression on, f32 moments — per step wall (the first marked as the
   warm-up), tokens/s, loss, grad_norm and lr, the warm-up and capture
   seconds, peak allocated and reserved memory, every loss and norm
   finite, every leaf changed — then one more step eager under
   ``torch.profiler`` (device time by phase, busy share) and one
   replayed (busy share, top kernels); (b) from the same weights and
   batches card vs CPU (2 layers at full width, 2 x 256 tokens): the
   first batch's gradients, then two steps, the card's second replayed
   — losses, grad norms and the params after them within stated bounds;
   (c) under deterministic algorithms (2 layers, 2 x 512 tokens) 4
   steps through the graph == 4 all eager, bit for bit (losses, grad
   norms, lrs, params, moments, step, residuals), and 4 steps straight
   == 2 + checkpoint + restore + 2, the resumed run capturing again: the
   restored state byte-identical, the data step resumed, the losses and
   final state equal; (d) deepseek-v2-lite-16b at full width, its depth
   cut to the dense layer and 3 MoE layers, 2 steps of 4096 tokens: aux
   loss, capacity drops, loss, capture seconds, peak memory; (e) the
   ``train_100m`` twin, 100 of its default 300 steps (the time limit),
   its loss falling by more than 0.5, capture seconds, peak memory;
15. the mesh layer (``[mesh]``; no kernel of the port may launch, counts
   set to 0 before each part and read after): a world of one on the card
   (NCCL over a ``FileStore``) and its (1, 1) (data, model) mesh — (a)
   qwen2-0.5b at full width, its depth cut to 4 of 24 layers, 2 steps of
   2 x 512 tokens with ``mesh=`` (eager) against the same 2 without (the
   second replayed) under deterministic algorithms: losses and params
   bit-equal (else [train] (b)'s bounds); (b) [train] (d)'s
   deepseek-v2-lite-16b cut, one step of 1 x 4096 tokens whose MoE
   layers go through ``moe_block_ep`` (counted), its loss against the
   no-mesh step's, step time and peak memory; (c) the pipelined prefill
   on a (1, 1, 1) (stage, data, model) mesh, 4 layers, 4 x 512 tokens (4
   rows, so 4 microbatches split them), 2 and 4 microbatches, against
   ``forward`` within 3e-2; then the group destroyed and (d) four gloo
   CPU ranks, spawned by this script at [train]'s start so they run
   while [train] and (a)–(c) do, at (2, 2): one deepseek smoke train
   step against the single-rank port (losses within 1e-4 relative);
16. the dry run (``[dryrun]``): (a) a process spawned at the script's
   start traces, on the meta device as rank 0 of fake 256- and
   512-rank process groups (``repro_torch.launch.dryrun``), qwen2-0.5b x
   train_4k / prefill_32k / decode_32k on 16 x 16 and 2 x 16 x 16,
   deepseek-v2-lite-16b x train_4k (expert-parallel, its all-to-alls)
   and falcon-mamba-7b x prefill_32k (the trip-count correction) on
   16 x 16, a line a cell (peak, arguments, FLOPs a rank beside
   k·N·D / chips, collective bytes, kernel calls); (b)
   ``verify_multipod`` on qwen2-0.5b's 2 x 16 x 16 train_4k records,
   every cross-pod collective with its tag; (c) qwen2-0.5b x decode_32k
   x 16 x 16 with real tensors as rank 0 on the card: 24 decode
   attention launches, the peak within 15 % of the trace's, collectives
   and launches equal to it; (d) the same for train_4k at full depth
   with 7 of its 16 rows a rank (16 need 120 GB at any depth); the
   kernel at (c)'s shape, q (8, 14, 64) over (8, 32768, 2, 64), is held
   to its plain version and timed in the kernel phase (row
   ``decode_attn_decode32k``);
17. profile one more classic request and one PNM request (the host
   split, timed span by span; [graph] (c) reads the device's busy time).

Prints the card's name and power limit, each phase's seconds, a
``kernels`` JSON line, and as its last line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
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
# the dense families the model check holds on the card against the CPU
SMOKE_ARCHS = ("qwen2-0.5b", "stablelm-12b", "nemotron-4-340b")


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
    """``(ms, trace)``: device time per call of ``fn``, the summed time of
    every CUDA kernel it launched, from ``torch.profiler`` (CUPTI), and
    which trace saw it; ``(None, None)`` when no trace records device
    activity.  A trace that saw none is taken once more with the CPU side
    traced too (a short CUDA-only trace has come back empty on the card
    for one kernel whose calls others' traces saw)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for trace, acts in (("profiler", [ProfilerActivity.CUDA]),
                        ("profiler, second trace",
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_self_device_us(e) for e in prof.key_averages()
                       if _on_device(e))
        if total_us > 0:
            return total_us / 1e3 / iters, trace
    return None, None


def _on_device(evt) -> bool:
    """A kernel or copy on the card (a CPU-side op's ``self`` device time
    is 0 anyway; this keeps the sum to device events)."""
    kind = getattr(evt, "device_type", None)
    return kind is None or "CUDA" in str(kind)


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def timed(torch, fn, iters: int = 50) -> dict:
    """``ms``: device time per call by the profiler, or — when the
    profiler sees no device work — the CUDA-event time of back-to-back
    calls, which includes the host's launch cadence and is no device
    time: ``ms_from`` says which ("profiler", "profiler, second trace"
    or "events"), and every
    line that prints ``ms`` names it; ``call_ms``: the event time."""
    call = time_ms(torch, fn, iters, min(5, iters))
    dev, trace = device_ms(torch, fn, min(20, iters))
    return {"ms": call if dev is None else dev, "call_ms": call,
            "ms_from": "events" if dev is None else trace}


def ms_label(r: dict) -> str:
    """How a :func:`timed` ``ms`` was taken, for its printed line."""
    return (f"device ({r['ms_from']})" if r["ms_from"] != "events"
            else "by CUDA events, back to back (the profiler saw no device "
            "work: not a device time)")


def us(r: dict) -> str:
    """A :func:`timed` ``ms`` in µs with how it was taken."""
    return f"{r['ms'] * 1e3:.2f} us {ms_label(r)}"


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
    print(f"[kernel] {what}: {us(warm)} back to back "
          f"({100 * b / warm['ms']:.1f}% of the bound), "
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
          f"{us(r)}, bound {r['bound_ms'] * 1e3:.3f} "
          f"us by {r['bound_by']}; the two-launch chain (standalone unpack, "
          f"then inverse + round) {us(chain)}, "
          f"{chain['call_ms'] * 1e3:.2f} us per call back to back; "
          f"standalone unpack {us(alone)} (bound "
          f"{b1 * 1e3:.3f} us), standalone inverse "
          f"{us(results['kv_delta_inv'])}", flush=True)


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
              f"{us(api)}, {api['call_ms'] * 1e3:.2f} "
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
    print(f"[kernel] launch floor: a 16-byte zero_() {us(floor)}, "
          f"{floor['call_ms'] * 1e3:.2f} us per call back to back",
          flush=True)
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
        parts.append(f"valid_len {valid}: {us(t)}, {blocks} "
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
        lines.append(f"valid_len {S}: {us(t)} (bound "
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
          f"B, {pos.size} events): the match launch {us(r)}, bound "
          f"{r['bound_ms'] * 1e3:.3f} us "
          f"(the words and hashes it reads + meta + events); the wrapper "
          f"(prep + match + one copy back) {us(wrapper)}, "
          f"{wrapper_wall * 1e3:.3f} ms wall per call; plain pipeline on "
          f"the card (what serving ran before this kernel) "
          f"{us(plain)}, {plain_wall * 1e3:.1f} ms wall per "
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

    # the dense families at smoke width: rmsnorm + GQA decode attention,
    # layernorm, squared ReLU (the MoE families' routing is held in [mla])
    diffs = {}
    for name in SMOKE_ARCHS:
        cfg = smoke_config(ARCHS[name])
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
            raise AssertionError(f"{name}: non-finite logits on the card")
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        # bf16 matmuls round at other places on the card: a few bf16 ulps
        if diff > 0.05 * scale:
            raise AssertionError(f"{name}: card logits differ from CPU by "
                                 f"{diff} (scale {scale})")
        diffs[name] = diff
    return diffs


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
# the host spans of a served request: (label, module under repro_torch,
# the attribute its callers look up at each call)
_SPANS = (
    ("prefill", "runtime.serving", "ServeEngine.prefill"),
    ("decode steps", "runtime.serving", "ServeEngine.decode"),
    ("model forward (eager: prefill, warm-up, capture)", "runtime.serving",
     "decode_step"),
    ("  GQA attention", "models.layers", "gqa_block"),
    ("  MLA attention", "models.layers", "mla_block"),
    ("  MoE", "models.layers", "moe_block"),
    ("cache windows to host", "runtime.serving", "ServeEngine._commit_pages"),
    ("tier encode", "core.tier", "TierStore._encode_commit"),
    ("  KV forward on card", "core.tier", "TierStore._transform_kv_windows"),
    ("  LZ4 match on card", "kernels.lz4", "lz4_match"),
    ("  LZ4 emit (host)", "core.codec", "lz4_emit_events"),
    ("tier decode", "core.tier", "TierStore._do_reads"),
    ("  unpack + inverse on card", "core.tier",
     "BitplaneLayout._decode_planes"),
    ("  PNM gather", "core.tier", "TierStore._do_gather"),
    ("  page scoring", "kernels.pnm_score", "page_scores_u16"),
    ("attention importance", "runtime.serving",
     "ServeEngine._apply_attention_importance"),
    ("  LZ4 decompress (host)", "core.codec", "decompress_batch"),
    ("readback into cache", "runtime.serving", "ServeEngine._apply_readback"),
)


class SpanTimer:
    """While active, the inclusive host seconds of each of ``spans``: the
    function wrapped where its callers look it up (a nested call counts
    once).  The standard library's profiler cannot take this split of a
    served request: on the card's Python (3.12.3) it drops calls made
    from frames that ran when it was enabled (PR 26; functions called
    directly from the profiled frame went unrecorded in a probe with no
    graph in sight)."""

    def __init__(self, spans=_SPANS):
        import importlib
        import inspect

        self.seconds = {label: 0.0 for label, _, _ in spans}
        self.undo = []
        for label, module, attr in spans:
            owner = importlib.import_module(f"repro_torch.{module}")
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            raw = inspect.getattr_static(owner, name)
            fn = getattr(owner, name)
            timed_fn = self._wrap(label, raw.__func__ if isinstance(
                raw, staticmethod) else fn)
            setattr(owner, name, staticmethod(timed_fn) if isinstance(
                raw, staticmethod) else timed_fn)
            self.undo.append((owner, name, raw))

    def _wrap(self, label, fn):
        import functools

        depth, seconds = [0], self.seconds

        @functools.wraps(fn)
        def timed_fn(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                seconds[label] += time.perf_counter() - t
        return timed_fn

    def restore(self):
        for owner, name, raw in reversed(self.undo):
            setattr(owner, name, raw)


def _request_kw(params, **overrides) -> dict:
    kw = dict(arch="qwen2-0.5b", device="trace", prompt_len=512, n_tokens=64,
              batch=1, requests=1, hbm_kv_budget=1 << 22, page_tokens=64,
              seed=1, torch_device="cuda", params=params, verbose=False)
    kw.update(overrides)
    return kw


def profile_request(torch, serve, params, **overrides):
    """Where one full-width request's time goes on the host: the
    inclusive seconds of the spans above (:class:`SpanTimer`; nested
    spans overlap)."""
    kw = _request_kw(params, **overrides)
    spans = SpanTimer()
    try:
        rep = serve(**kw)
    finally:
        spans.restore()
    label = "PNM request" if kw.get("pnm_topk") is not None else "request"
    print(f"[profile] one {kw['arch']} {label}, host spans: wall "
          f"{rep.wall_s:.3f} s; " + "; ".join(
              f"{k} {v:.3f}" for k, v in spans.seconds.items())
          + " (s, inclusive)", flush=True)


def device_events(prof) -> tuple:
    """``({name: (ns, count)} of the kernels and copies on the card, all
    events)`` of a ``torch.profiler`` trace, from its raw Kineto events:
    ``key_averages`` took 11.2 s for a request's ~147,000 events on the
    card's host, the raw events 0.6 s, with the same busy sum (PR 26)."""
    events = prof.profiler.kineto_results.events()
    by_name = {}
    for e in events:
        if "CUDA" in str(e.device_type()):
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    return by_name, len(events)


def device_profile(torch, serve, params, **overrides) -> dict:
    """One full-width request under ``torch.profiler`` (device activity
    only: CPU-op tracing of a whole request costs minutes of
    post-processing): its wall, the device's busy seconds (the summed
    time of every kernel and copy on the card), those events, all events
    (the runtime calls too, as ``key_averages`` counts them), and the top
    five kernels by time (:func:`device_events`)."""
    from torch.profiler import ProfilerActivity, profile

    kw = _request_kw(params, **overrides)
    with profile(activities=[ProfilerActivity.CUDA]) as tprof:
        rep = serve(**kw)
    by_name, n_events = device_events(tprof)
    busy_s = sum(ns for ns, _ in by_name.values()) / 1e9
    return dict(wall_s=rep.wall_s, busy_s=busy_s,
                device_events=sum(n for _, n in by_name.values()),
                events=n_events,
                attn_s=sum(ns for k, (ns, _) in by_name.items()
                           if "decode_attn" in k) / 1e9,
                top=sorted(((k, ns / 1e3, n) for k, (ns, n) in
                            by_name.items()), key=lambda t: -t[1])[:5])


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
# fused bitplane_unpack launch per window group); decode attention at the
# position on the device (the captured step's, each replay counted)
SERVING_KERNELS = ("bitplane_pack", "lz4_prep", "lz4_match",
                   "decode_attn_devlen", "kv_delta_fwd", "bitplane_unpack")


def check_serving_launches(tag: str, launches: dict):
    """A serving path's launch counts (set to 0 just before it ran, read
    just after): each serving kernel above 0, the match once a flush, and
    decode attention never at a host length (every decode step goes
    through the captured step, whose position is on the device)."""
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched")
    if launches["decode_attn"]:
        raise AssertionError(f"{tag}: decode attention ran at a host "
                             f"length: an eager decode step ({launches})")
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
# [sched] runs the first 6 of qwen2-0.5b's 24 layers (a depth cut for
# the script's time limit) with a quarter of the HBM budget, so each
# layer keeps the pages it kept at full depth and spills the ones it
# spilled
SCHED_LAYERS = 6
SCHED_CUT_ENGINE = dict(page_tokens=64, hbm_kv_budget=1 << 20)
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


class CaptureProbe:
    """While active, record each engine's decode-step capture
    (``runtime.serving.DecodeGraph``): its warm-up and capture host
    seconds."""

    def __init__(self):
        from repro_torch.runtime import serving

        self.module, self.cls = serving, serving.DecodeGraph
        self.times = []
        times = self.times

        class Recorded(self.cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                times.append((self.warmup_s, self.capture_s))

        serving.DecodeGraph = Recorded

    def restore(self):
        self.module.DecodeGraph = self.cls

    def line(self) -> str:
        if not self.times:
            return "no decode step captured"
        w, c = zip(*self.times)
        return (f"{len(c)} decode steps captured, capture "
                f"{sum(c) / len(c):.3f} s mean ({max(c):.3f} max), warm-up "
                f"{sum(w) / len(w):.3f} s mean (host seconds)")


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
        captures = CaptureProbe()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launches()
        try:
            rep, wall = drive_scheduler(torch, sched, trace)
        finally:
            captures.restore()
            if probe is not None:
                probe.restore()
        launches = dict(build.LAUNCHES)
        print(f"[sched] {case}: {captures.line()}; peak allocated "
              f"{_peak(torch, dev)} B", flush=True)
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
    captures = CaptureProbe()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    try:
        toks = multi.generate(prompts, n_new)
    finally:
        captures.restore()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    print(f"[streams] {captures.line()}; peak allocated "
          f"{_peak(torch, dev)} B", flush=True)
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
WEIGHT_LAYERS = 2            # the first 2 of the 24 decoder layers: a
                             # depth cut for the script's time limit
FLEET_LAYERS = 1             # the replicate-weights fleet's share
FLEET_SHARDS = 4
BLOCK_ELEMS = 2048           # core.bitplane.BLOCK_ELEMS: a 4 KB block


# the host spans of the weight path, timed by SpanTimer: (label, module
# under repro_torch, the attribute its callers look up at each call)
_WEIGHT_LOAD_SPANS = (
    ("put_many", "runtime.weights", "WeightStore.put_many"),
    ("  units to host", "runtime.weights", "_bf16_words"),
    ("  blocks staged", "core.tier", "TierStore._stage_write"),
    ("  pack on card", "kernels.bitplane", "pack_planes_slab"),
    ("  codec", "core.codec", "compress_slab"),
    ("    pre-screen (host)", "core.codec", "_prescreen_slab"),
    ("    LZ4 prep + match on card", "kernels.lz4", "lz4_match"),
    ("    LZ4 emit (host)", "core.codec", "lz4_emit_events"),
    ("  blocks committed", "core.tier", "TierStore._commit"),
)
_WEIGHT_FETCH_SPANS = (
    ("fetch_all", "runtime.weights", "WeightStore.fetch_all"),
    ("  LZ4 decompress (host)", "core.codec", "decompress_batch"),
    ("  unpack + round on card", "core.tier",
     "BitplaneLayout._decode_planes"),
    ("  units assembled", "core.tier", "TierStore._assemble"),
    ("  words to card", "runtime.weights", "WeightStore._tensor"),
)


def _spans(timer) -> str:
    """``label seconds`` of each span a :class:`SpanTimer` took."""
    return "; ".join(f"{label} {t:.3f}" for label, t in timer.seconds.items())


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
                 "decode_attn", "decode_attn_devlen", "pnm_score",
                 "elastic_matmul"):
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
    # card store's load and fetch time goes (SpanTimer) ---------------------
    layer0 = {k: v for k, v in units.items() if k.startswith("L0.")}
    tiers = {}
    for where in (dev, torch.device("cpu")):
        store = WeightStore("trace", device=where)
        rec = Recorder(store.tier)
        l0_timer = SpanTimer(_WEIGHT_LOAD_SPANS)
        try:
            store.put_many({k: (w.to(where), imp)
                            for k, (w, imp) in layer0.items()})
            _sync(torch, where)
        finally:
            l0_timer.restore()
        tiers[where.type] = (store.tier,
                             [_receipt_fields(r) for r in rec.recs])
        if where == dev:
            l0_load, l0_fetch = l0_timer, SpanTimer(_WEIGHT_FETCH_SPANS)
            try:
                store.fetch_all()
                _sync(torch, where)
            finally:
                l0_fetch.restore()
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
    print("[profile] layer 0's load on the card: " + _spans(l0_load)
          + "; its fetch_all: " + _spans(l0_fetch)
          + " (s, inclusive, wrappers)", flush=True)

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


# [mla]: deepseek-v2-lite-16b at full width (d 2048, MLA with a
# 512-channel latent, 64 routed experts top-6 + 2 shared, the dense first
# layer; depth cut below), random bf16 weights from seed 0 drawn on the
# card; a trace tier, PAPER_POLICY, 64-token pages, a 1 MiB HBM KV budget
# (16 of the 64 KiB c_kv pages stay on the card), 512 prompt + 64 new
# tokens.
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_VOCAB = 102400
MLA_C = 512                  # kv_lora_rank: the latent's channels a token
# a depth cut for the script's time limit: the dense first layer and 8 of
# the 26 MoE layers (every width as the arch file has it), with a 1 MiB
# HBM budget so the prefill spills as the 27 layers did at 4 MiB
MLA_LAYERS = 9
MLA_FLUSH_WINDOWS = 48       # the prefill flush: 48 of the 64 prompt
                             # pages spill, and its gather scores them
MLA_SERVE = dict(arch=MLA_ARCH, smoke=False, device="trace", prompt_len=512,
                 n_tokens=64, batch=1, hbm_kv_budget=1 << 20, page_tokens=64,
                 seed=0, n_layers=MLA_LAYERS, verbose=False)
# the kernels of a served MLA request: decode attention is eager PyTorch
# over the re-expanded latent, as in the reference
MLA_KERNELS = ("bitplane_pack", "lz4_prep", "lz4_match", "kv_delta_fwd",
               "bitplane_unpack")


def _latent_row(name, base, **kw) -> dict:
    return dict(name=name, route="cuda", max_abs_err=0.0, library_ms=None,
                **base, **kw)


def check_latent_kernels(torch, build, k_bitplane, k_kv, k_pnm, results,
                         fwd_windows: int = MLA_FLUSH_WINDOWS,
                         score_pages: int = MLA_FLUSH_WINDOWS,
                         C: int = MLA_C, dev="cuda"):
    """The KV forward, the fused KV read and page scoring at the latent's
    512 channels, at the shapes [mla] gives them (it checks that it
    does): bit-equal to their plain versions (the read at every view),
    timed beside the plain version and the bound.  Rows ``*_latent`` of
    the ``kernels`` line; [mla] fills in their launches.  Timed in the
    [kernel] phase: late in the script, after [mla], the profiler's short
    traces missed device events on the card."""
    import numpy as np

    rng = np.random.default_rng(11)

    def windows(B):
        f = rng.standard_normal((B, WINDOW, C)) * np.exp(
            rng.uniform(-2, 2, C))
        u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
        u.reshape(-1)[::97] = 0x7FC0
        u[0, : WINDOW // 2, 0] = 0x3F80          # a histogram tie
        u[0, WINDOW // 2 :, 0] = 0x4000
        return torch.from_numpy(u.view(np.int16)).to(dev)

    x = windows(fwd_windows)
    got, beta = k_kv.kv_forward(x)
    want, want_beta = k_kv.kv_forward_plain(x)
    _sync(torch, torch.device(dev))
    if not (torch.equal(got, want) and torch.equal(beta, want_beta)
            and int(beta[0, 0]) == 127):
        raise AssertionError(f"kv_delta_fwd {tuple(x.shape)} differs from "
                             "its plain version")
    elems = fwd_windows * WINDOW * C
    b, by = bound_ms(4 * elems + fwd_windows * C, 12 * elems)
    results["kv_delta_fwd_latent"] = _latent_row(
        "kv_delta_fwd_latent", timed(torch, lambda: k_kv.kv_forward(x)),
        source="src/repro_torch/csrc/kv_delta.cu",
        replaces="src/repro/kernels/kv_delta.py:28",
        plain_ms=timed(torch, lambda: k_kv.kv_forward_plain(x))["ms"],
        bound_ms=b, bound_by=by)

    # one decode slab of the latent: 2 windows of 64 x 512
    nwin = min(DECODE_ELEMS // (WINDOW * C), fwd_windows)
    win = x[:nwin].contiguous()
    cm, beta = k_kv.kv_forward(win)
    planes = k_bitplane.pack_planes_u16(cm.reshape(-1))
    nbytes = planes.shape[1]
    starts = [i * WINDOW * C for i in range(nwin)]
    for view in read_views():
        ids = view.fetched_planes()
        rows = planes[list(ids)].contiguous()
        got = k_bitplane.unpack_kv_windows(rows, ids, starts, WINDOW, C,
                                           beta, view)
        want = k_bitplane.unpack_kv_windows_plain(rows, ids, starts, WINDOW,
                                                  C, beta, view)
        _sync(torch, torch.device(dev))
        if not torch.equal(got, want) or (view.is_full
                                          and not torch.equal(got, win)):
            raise AssertionError(f"fused KV read of the latent "
                                 f"({view.name}) differs")
    man4 = read_views()[1]
    ids = man4.fetched_planes()
    rows = planes[list(ids)].contiguous()
    elems = nwin * WINDOW * C
    b, by = bound_ms(len(ids) * nbytes + nwin * C + 8 * nwin + 2 * elems,
                     (3 * len(ids) + 20) * elems)
    results["bitplane_unpack_latent"] = _latent_row(
        "bitplane_unpack_latent", timed(torch, lambda: k_bitplane
                                        .unpack_kv_windows(
                                            rows, ids, starts, WINDOW, C,
                                            beta, man4)),
        source="src/repro_torch/csrc/bitplane_unpack.cu",
        replaces="src/repro/kernels/bitplane.py:51",
        plain_ms=timed(torch, lambda: k_bitplane.unpack_kv_windows_plain(
            rows, ids, starts, WINDOW, C, beta, man4))["ms"],
        bound_ms=b, bound_by=by)

    # page scoring: the candidates of a latent gather, 64 rows x 512
    f = rng.standard_normal((score_pages, PAGE_ROWS, C)) * 0.7
    u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    pages = torch.from_numpy(u.view(np.int16)).to(dev)
    digest = torch.from_numpy(
        rng.standard_normal(C).astype(np.float32)).to(dev)
    full = torch.full((score_pages,), PAGE_ROWS, dtype=torch.int32,
                      device=dev)
    ragged = torch.from_numpy(rng.integers(0, PAGE_ROWS + 1, score_pages)
                              .astype(np.int32)).to(dev)
    for valid in (full, ragged):
        if not same_scores(torch, k_pnm.page_scores(pages, valid, digest),
                           k_pnm.page_scores_plain(pages, valid, digest)):
            raise AssertionError("pnm_score at 512 channels differs from "
                                 "its plain version")
    n = score_pages * PAGE_ROWS * C
    b, by = bound_ms(2 * n + C * 4 + score_pages * 8, 2 * n)
    results["pnm_score_latent"] = _latent_row(
        "pnm_score_latent",
        timed(torch, lambda: k_pnm.page_scores(pages, full, digest)),
        source="src/repro_torch/csrc/pnm_score.cu",
        replaces="src/repro/kernels/pnm_score.py:66",
        plain_ms=timed(torch, lambda: k_pnm.page_scores_plain(
            pages, full, digest))["ms"],
        bound_ms=b, bound_by=by)


def check_mla_decode_forward(torch, cfg, params, prompt, dev="cuda"):
    """decode == forward at full width, for the prompt's last position:
    one forward over the 512-token prompt against a prefill of its first
    511 tokens and a single-token decode step of the last, at a capacity
    that drops nothing (cap = k * T).  The router's logits are bf16 and
    the two runs round them from matmuls of other shapes, so a near-tie
    may route a token apart: every routing decision is pinned to the
    forward's, each unpinned decision that differed must have been within
    4 bf16 ulps of a tie, and the logits then agree within the
    reference's decode == forward bound (rtol = atol = 0.15,
    ``tests/test_arch_smoke.py``)."""
    import dataclasses

    from repro_torch.models import layers, model

    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    route = layers.route
    fwd, flips, near = [], [0], [0]
    pinned = []

    def recording(flat, router, k):
        out = route(flat, router, k)
        fwd.append(out)
        return out

    def pinning(flat, router, k):
        gates, experts = route(flat, router, k)
        want_g, want_e = pinned.pop(0)
        differ = (experts.sort(-1).values != want_e.sort(-1).values).any(-1)
        if bool(differ.any()):
            logits = (flat[differ] @ router).float()
            srt = logits.sort(-1, descending=True).values
            gap = srt[:, k - 1] - srt[:, k]
            ulp = 2.0 ** (torch.floor(torch.log2(logits.abs().amax(-1))) - 7)
            flips[0] += int(differ.sum())
            near[0] = max(near[0], float((gap / ulp).max()))
        return want_g, want_e

    toks = torch.from_numpy(prompt).to(dev)
    S = toks.shape[1]
    with torch.no_grad():
        layers.route = recording
        try:
            full, _ = model.forward(cfg, params, {"tokens": toks,
                                                  "cache_pos": 0},
                                    model.init_cache(cfg, 1, S, device=dev))
        finally:
            layers.route = route
        pinned += [(g[: S - 1], e[: S - 1]) for g, e in fwd]
        pinned += [(g[S - 1 :], e[S - 1 :]) for g, e in fwd]
        cache = model.init_cache(cfg, 1, S, device=dev)
        layers.route = pinning
        try:
            model.forward(cfg, params, {"tokens": toks[:, : S - 1],
                                        "cache_pos": 0}, cache)
            step, _ = model.forward(cfg, params, {"tokens": toks[:, S - 1:],
                                                  "cache_pos": S - 1}, cache)
        finally:
            layers.route = route
    if pinned:
        raise AssertionError("decode == forward: routes left unpinned")
    if near[0] > 4.0:
        raise AssertionError(f"decode == forward: a router choice flipped "
                             f"{near[0]:.2f} bf16 ulps from a tie")
    a, b = step[0, -1].float(), full[0, -1].float()
    diff = (a - b).abs()
    if not bool(torch.isfinite(a).all()) or \
            bool((diff > 0.15 + 0.15 * b.abs()).any()):
        raise AssertionError(f"decode != forward at full width: max |diff| "
                             f"{float(diff.max())}")
    print(f"[mla] decode == forward at the prompt's last position: max "
          f"|diff| {float(diff.max()):.4g} (logits up to "
          f"{float(b.abs().max()):.3g}); {flips[0]} of "
          f"{S * len(fwd)} token-layer routes flipped apart from the "
          f"forward's, the widest {near[0]:.2f} bf16 ulps from a tie",
          flush=True)


def mla_path(torch, build, k_bitplane, k_kv, k_pnm, serve, results,
             cfg=None, dev="cuda"):
    """[mla]: serve deepseek-v2-lite-16b at full width (its depth cut to
    :data:`MLA_LAYERS`) in four cases,
    launch counts set to 0 just before each and read just after: (a) two
    classic requests; (b) a covering gather (tokens == a's first); (c)
    top-16 gathers with attention importance; (d) LOSSLESS_POLICY with
    spills (tokens == a run whose budget holds every page).  Then the
    card's tier against the CPU's on one flush of c_kv pages, decode ==
    forward, and the kernels at the latent's shapes.  Returns the summed
    launches of the classic and PNM cases."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.models.model import init_params

    cfg = cfg or dataclasses.replace(ARCHS[MLA_ARCH], n_layers=MLA_LAYERS)
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    _sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[mla] {MLA_ARCH}: {n_params} parameters "
          f"({_allocated(torch, dev)} B on the card) drawn in "
          f"{time.perf_counter() - t0:.2f} s; peak {_peak(torch, dev)} B",
          flush=True)
    fwd_shapes = ShapeRecorder(k_kv, "kv_forward")
    score_shapes = ShapeRecorder(k_pnm, "page_scores")
    cases = {
        "a classic x2": dict(requests=2),
        "b covering gather": dict(requests=1, pnm_topk=1 << 20),
        "c top-16, attention": dict(requests=1, pnm_topk=16,
                                    importance="attention"),
        "d lossless, spilling": dict(requests=1, lossless_only=True),
        "d' lossless, no spill": dict(requests=1, lossless_only=True,
                                      hbm_kv_budget=1 << 40),
    }
    reps, total = {}, {name: 0 for name in build.KERNELS}
    try:
        for case, extra in cases.items():
            build.reset_launches()
            rep = serve(**{**MLA_SERVE, **extra}, params=params,
                        torch_device=dev)
            _sync(torch, dev)
            launches = dict(build.LAUNCHES)
            for toks in rep.tokens:
                if toks.shape != (1, 64) or toks.min() < 0 or \
                        toks.max() >= MLA_VOCAB:
                    raise AssertionError(f"{case}: bad tokens {toks.shape}")
            print(f"[mla] {case}: wall tok/s {rep.tok_s:.3f}; c_kv ratio "
                  f"{rep.kv_compression_ratio:.4f} ({rep.kv_logical_bytes} "
                  f"B logical in {rep.kv_stored_bytes} B); tier link out "
                  f"{rep.tier_link_out} B, DRAM read {rep.tier_dram_read} B; "
                  f"spilled {rep.spilled_pages}, read back "
                  f"{rep.readback_pages}, gathered {rep.gathered_pages}; "
                  f"peak {_peak(torch, dev)} B; launches {launches}",
                  flush=True)
            reps[case] = rep
            if case.startswith("d'"):
                if rep.spilled_pages:
                    raise AssertionError("the unspilled run spilled")
                continue
            for name in MLA_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"{case}: {name} never launched")
            if launches["lz4_match"] != launches["lz4_prep"]:
                raise AssertionError(f"{case}: the match did not launch once "
                                     f"a flush: {launches}")
            if launches["decode_attn"] or launches["decode_attn_devlen"] \
                    or launches["kv_delta_inv"] or launches["elastic_matmul"]:
                raise AssertionError(f"{case}: launched a kernel MLA serving "
                                     f"does not run: {launches}")
            pnm = "pnm_topk" in extra
            if pnm != (launches["pnm_score"] > 0) or \
                    pnm != (rep.gathered_pages > 0):
                raise AssertionError(f"{case}: page scoring {launches}")
            if case[0] in "abc":
                for name in total:
                    total[name] += launches[name]
    finally:
        k_kv.kv_forward = fwd_shapes.original
        k_pnm.page_scores = score_shapes.original
    a, b, c, d, d0 = reps.values()
    if a.spilled_pages <= 0 or a.readback_pages <= 0 or \
            b.readback_pages != 0 or d.spilled_pages <= 0:
        raise AssertionError("[mla] spilled or read back nothing")
    if not np_equal(a.tokens[0], b.tokens[0]):
        raise AssertionError("[mla] the covering gather changed the tokens")
    if not np_equal(d.tokens[0], d0.tokens[0]):
        raise AssertionError("[mla] lossless spill changed the tokens")
    if not c.tier_link_out < b.tier_link_out:
        raise AssertionError(f"[mla] top-16 shipped {c.tier_link_out} B, the "
                             f"covering gather {b.tier_link_out} B")
    tokens = 4 * 64
    print(f"[mla] b == a tokens, d == d' tokens; c ships "
          f"{c.tier_link_out / b.tier_link_out:.4f}x b's link bytes; "
          f"launches per token over a-c ({tokens} tokens): "
          + ", ".join(f"{k} {total[k] / tokens:.4f}"
                      for k in MLA_KERNELS + ("pnm_score",))
          + f"; KV forward batches {fwd_shapes.counts}; scored page stacks "
          f"{score_shapes.counts}", flush=True)

    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 512)).astype(np.int32)
    check_latent_flush(torch, cfg, params, prompt, dev)
    check_mla_decode_forward(torch, cfg, params, prompt, dev)
    if cfg.kv_lora_rank == MLA_C and (
            f"{MLA_FLUSH_WINDOWS}x{WINDOW}x{MLA_C}" not in fwd_shapes.counts
            or f"{MLA_FLUSH_WINDOWS}x{PAGE_ROWS}x{MLA_C}"
            not in score_shapes.counts):
        raise AssertionError(f"the [kernel] checks' latent shapes are not "
                             f"ones [mla] ran: {fwd_shapes.counts}, "
                             f"{score_shapes.counts}")
    if dev.type == "cuda":      # the host split of a request
        profile_request(torch, serve, params,
                        arch=MLA_ARCH, n_layers=MLA_LAYERS,
                        hbm_kv_budget=MLA_SERVE["hbm_kv_budget"])
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[mla] params freed: {_allocated(torch, dev)} B allocated; peak "
          f"of the phase {_peak(torch, dev)} B", flush=True)
    results["kv_delta_fwd_latent"]["launches"] = total["kv_delta_fwd"]
    results["bitplane_unpack_latent"]["launches"] = total["bitplane_unpack"]
    results["pnm_score_latent"]["launches"] = total["pnm_score"]
    return total


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def check_latent_flush(torch, cfg, params, prompt, dev="cuda"):
    """The card's tier against the CPU's on one flush of c_kv pages: an
    engine on the card prefills the prompt, and its committed pages (8
    windows a stacked layer) go to a card pool and a CPU pool whose
    budget keeps all but one page a stacked layer on the HBM side, so
    that many spill in one flush; stored payloads and flags, per-page
    receipts and the readback words are identical."""
    import numpy as np

    from repro_torch.models.model import cfg_layers
    from repro_torch.runtime import PAPER_POLICY, KVPagePool, ServeEngine

    eng = ServeEngine(cfg, params, max_seq=512 + 64 + 64, batch=1,
                      page_tokens=64, hbm_kv_budget=1 << 40,
                      policy=PAPER_POLICY, device=dev)
    log = PoolLog(eng.pool)
    eng.prefill(prompt)
    (name, pages), = log.calls
    kinds = {e[1] for e in pages}
    eng.retire()
    n_layers = cfg_layers(cfg)
    budget = (len(pages) - n_layers) * 64 * cfg.kv_lora_rank * 2
    pools = [KVPagePool("trace", page_tokens=64, hbm_budget_bytes=budget,
                        policy=PAPER_POLICY, device=d) for d in (dev, "cpu")]
    out = []
    for pool in pools:
        pool.append_pages(pages)
        events, pool.spill_events = pool.spill_events, []
        out.append(([p.key for p in events], pool.read_pages(events)))
    (ka, da), (kb, db) = out
    if kinds != {"c_kv"} or len(ka) != n_layers or ka != kb or \
            not all(np_equal(x, y) for x, y in zip(da, db)):
        raise AssertionError(f"[mla] latent flush: kinds {kinds}, spilled "
                             f"{len(ka)} / {len(kb)}, readback differs")
    ta, tb = pools[0].tier, pools[1].tier
    if ta._tensors.keys() != tb._tensors.keys() or any(
            [(blk.payloads, blk.flags) for blk in ta._tensors[k]]
            != [(blk.payloads, blk.flags) for blk in tb._tensors[k]]
            for k in ta._tensors):
        raise AssertionError("[mla] latent flush: stored bytes differ")
    if {k: vars(v) for k, v in pools[0].page_traffic.items()} != \
            {k: vars(v) for k, v in pools[1].page_traffic.items()} or \
            vars(ta.stats) != vars(tb.stats):
        raise AssertionError("[mla] latent flush: receipts differ")
    print(f"[mla] one flush of {n_layers} c_kv pages (64 x "
          f"{cfg.kv_lora_rank}): card tier == "
          f"CPU tier, {ta.stats.dram_bytes_stored} B stored for "
          f"{ta.stats.raw_bytes_stored} B, payloads, flags, receipts and "
          "readback words", flush=True)
    for pool in pools:
        pool.release()


def examples_path(torch, build, dev="cuda"):
    """Run the four example twins on the card, as ``python -m
    repro_torch.examples.<name>`` runs them without ``--cpu``: each one's
    own assertions, the tier kernels launched, the quickstart's tier
    numbers equal to its run on the CPU (the model's are not compared:
    bf16 matmuls round at other places on the card), and serve_elastic's
    frontier: lossless agrees with itself on every top-1, tier DRAM reads
    fall from lossless to aggressive."""
    import contextlib
    import io

    from repro_torch.examples import (
        quickstart, serve_async, serve_continuous, serve_elastic,
    )

    twins = (("quickstart", quickstart), ("serve_async", serve_async),
             ("serve_continuous", serve_continuous),
             ("serve_elastic", serve_elastic))
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
            need += ("kv_delta_fwd", "decode_attn_devlen")
        if any(not launches[k] for k in need) or \
                launches["lz4_prep"] != launches["lz4_match"] or \
                launches["kv_delta_inv"] or launches["elastic_matmul"]:
            raise AssertionError(f"example {name} on the card launched "
                                 f"{launches}")
        print(f"[examples] {name} on {dev}: {wall:.3f} s wall, launches "
              f"{launches}", flush=True)
        out[name] = res
    rows = out["serve_elastic"]["rows"]
    dram = [r["dram_read"] for r in rows.values()]
    if rows["lossless (all BF16)"]["top1"] != 1.0 or \
            not dram[0] > dram[2] > dram[3]:
        raise AssertionError(f"serve_elastic's frontier on the card: {rows}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = quickstart.main(["--cpu"])
    if cpu != out["quickstart"]:
        raise AssertionError(f"quickstart on the card {out['quickstart']} "
                             f"!= on the CPU {cpu}")
    print("[examples] quickstart's ratios, DRAM bytes and man4 error on the "
          "card == on the CPU", flush=True)
    return out


# [ssm] and [frontends]: the recurrent and non-token families at full
# width.  A recurrent model serves one classic request of 512 + 64 tokens
# (its state pages nothing, so the tier stays empty and no tier kernel
# runs); the frontend models run from seeded embeds.
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")
# a depth cut for the time limit: 8 of falcon-mamba's 64 Mamba1 layers,
# and 8 of zamba2's 81 Mamba2 layers with 1 of its 13 shared-block
# applications (after layer 0): every op still runs
SSM_LAYERS = {"falcon-mamba-7b": 8, "zamba2-7b": 8}
SSM_SERVE = dict(smoke=False, device="trace", prompt_len=512, n_tokens=64,
                 batch=1, requests=1, hbm_kv_budget=1 << 22, page_tokens=64,
                 seed=0, verbose=False)
LAYER_TOKENS = 16            # one full-width layer, card vs CPU
CARD_ULPS = 4                # ... within this many bf16 ulps of its largest
                             # value: the two devices sum bf16 matmuls in
                             # other orders, so a projection may round apart
HUBERT_ARCH, LLAVA_ARCH = "hubert-xlarge", "llava-next-34b"
FRONT_TOKENS = 512           # hubert's frames; llava's prompt embeds
LLAVA_LAYERS = 4             # of 60: a depth cut, since 68 GB of bf16
                             # parameters and their f32 draw do not fit
LLAVA_HEADS, LLAVA_KV, LLAVA_HD = 56, 8, 128
LLAVA_SEQ = 512 + 64 + 64    # the cache of a 512 + 64 request, as serve's
LLAVA_VALID = 512 + 64


def _ulp(t) -> float:
    """One bf16 ulp at the largest magnitude of ``t``."""
    import math

    return 2.0 ** (math.floor(math.log2(max(float(t.abs().max()), 1e-30)))
                   - 7)


def margin_bound(np, ref, got, tag: str) -> str:
    """The margin-aware greedy bound of
    ``tests/test_kv_dtype.py::test_fp8_cache_decode_tracks_bf16``: logits
    ``got`` against ``ref`` (rows of one sequence), greedy choices apart
    only where the reference's top two lie within 4 RMS."""
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    ok = (rms < 0.5 * float(np.median(margin))
          and bool(agree[margin > 4.0 * rms].all()) and agree.mean() > 0.8
          and np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99)
    if not ok:
        raise AssertionError(f"{tag}: greedy tokens beyond the margin-aware "
                             f"bound (rms {rms}, median margin "
                             f"{np.median(margin)}, agree {agree.mean()})")
    return f"rms {rms:.4g}, greedy agree {agree.mean():.4f}"


def decode_vs_forward(torch, cfg, params, inputs, key, prompt_len, dev,
                      tag, steps=None, dtype=None, greedy=True,
                      noise=True):
    """Teacher-forced decode == forward over one sequence ``inputs`` (1,
    T[, d]) fed as ``key`` (tokens or embeds), in the params' dtype (the
    cache in ``dtype``, default ``cfg.kv_dtype``).  ``steps`` are the
    decode's logits (the prompt's last position, then one row a later
    input: a served run's), else computed here by a prefill of the first
    ``prompt_len`` through a cache of serve's size and one step for each
    later input.  Against one forward without a cache over all T; with
    ``greedy`` the greedy choices within the margin-aware bound.

    The bound is the reference's decode == forward bound (rtol = atol =
    0.15, ``tests/test_arch_smoke.py``), with ``noise`` widened by twice
    the forward's own noise: the forward in two chunks through the cache
    (the prompt, then the rest) against the forward in one, which at
    full width in bf16 differs by as much as a decode does (cuBLAS sums
    a GEMM of other rows in another order, and deep random-weight models
    carry a rounding flip forward).  Returns ``(prefill logits (T0, V), step
    logits, forward logits (T, V), the forward's own noise)`` as f32 on
    the host."""
    import numpy as np

    from repro_torch.models import model

    T = inputs.shape[1]
    with torch.no_grad():
        full, _ = model.forward(cfg, params, {key: inputs})
        full = full[0].float().cpu()
        cache = model.init_cache(cfg, 1, T + 64, device=dev, dtype=dtype)
        pre, cache = model.decode_step(cfg, params, {
            key: inputs[:, :prompt_len], "cache_pos": 0}, cache)
        pre = pre[0].float().cpu()
        chunked, noise = noise, 0.0
        if chunked:
            rest, _ = model.decode_step(cfg, params, {
                key: inputs[:, prompt_len:], "cache_pos": prompt_len},
                _map_leaves(cache, lambda t: t.clone()))
            noise = float((torch.cat([pre, rest[0].float().cpu()])
                           - full).abs().max())
        if steps is None:
            rows = [pre[-1]]
            for t in range(prompt_len, T):
                lg, cache = model.decode_step(cfg, params, {
                    key: inputs[:, t:t + 1], "cache_pos": t}, cache)
                rows.append(lg[0, -1].float().cpu())
            steps = torch.stack(rows)
    del cache
    want = full[prompt_len - 1:]
    diff = (steps - want).abs()
    over = diff > 0.15 + 0.15 * want.abs()
    if not bool(torch.isfinite(steps).all()) or \
            bool((diff > 0.15 + 0.15 * want.abs() + 2 * noise).any()):
        raise AssertionError(f"{tag}: decode != forward: max |diff| "
                             f"{float(diff.max())}, the forward's own "
                             f"noise {noise}")
    agree = float((steps.argmax(-1) == want.argmax(-1)).float().mean())
    if greedy:
        margin_bound(np, want.numpy(), steps.numpy(), tag)
    kind = str(params["final_norm"]["scale"].dtype).split(".")[-1]
    print(f"[{tag}] {kind} decode == forward over {T} positions (the prompt's last and "
          f"{T - prompt_len} steps): max |diff| {float(diff.max()):.4g}, "
          f"rms {float(diff.pow(2).mean().sqrt()):.4g} (logits up to "
          f"{float(want.abs().max()):.3g}); {int(over.sum())} of "
          f"{over.numel()} past 0.15 + 0.15 |x|; "
          + (f"the forward in two chunks vs one: max |diff| {noise:.4g}; "
             if chunked else "")
          + f"greedy agree {agree:.4f}"
          + (" (margin-aware bound held)" if greedy else ""), flush=True)
    return pre, steps, full, noise


def layer_card_vs_cpu(torch, cfg, params, dev, tag, seq=LAYER_TOKENS):
    """One full-width layer (layer 0) on the card against the same layer
    on the CPU from the same weights and input: a Mamba mixer from a
    random incoming state (its output, f32 scan state and conv state), or
    a transformer block without a cache.  Outputs within
    :data:`CARD_ULPS` bf16 ulps of their largest value, and so are the
    f32 scan state and the conv inputs: both come from bf16 projections,
    which the two devices may round apart."""
    import numpy as np

    from repro_torch.models import layers, model

    rng = np.random.default_rng(7)
    p = model._layer(params["layers"], 0)
    x = torch.from_numpy(rng.standard_normal(
        (1, seq, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    mix = (layers.mamba1_mix if cfg.ssm == "mamba1" else
           layers.mamba2_mix if cfg.ssm == "mamba2" else None)
    state = None
    if mix is not None:
        spec = model.cache_spec(cfg, 1, seq)["layers"]
        state = {k: torch.from_numpy(rng.standard_normal(
            leaf.shape[1:]).astype(np.float32) * 0.5).to(leaf.dtype)
            for k, leaf in spec.items()}
    out = {}
    with torch.no_grad():
        for where in (torch.device(dev), torch.device("cpu")):
            pw = _to(p, where)
            if mix is None:
                pos = torch.arange(seq, device=where,
                                   dtype=torch.int32)[None]
                y, _ = model._block(cfg, pw, x.to(where), positions=pos,
                                 cache=None, cache_pos=0)
                out[where.type] = (y.float().cpu(),)
            else:
                st = {k: v.clone().to(where) for k, v in state.items()}
                y = mix(x.to(where), pw, cfg, state=st)
                out[where.type] = (y.float().cpu(), st["ssm"].cpu(),
                                   st["conv"].float().cpu())
            del pw
    card, cpu = out[torch.device(dev).type], out["cpu"]
    err = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
    ulps = [e / _ulp(b) for e, b in zip(err, cpu)]
    if max(ulps) > CARD_ULPS:
        raise AssertionError(f"[{tag}] layer 0 card vs CPU: max |diff| "
                             f"{err}, bf16 ulps {ulps}")
    what = "output" + (", f32 state, conv state" if state is not None
                       else "")
    print(f"[{tag}] one full-width layer (layer 0, {seq} tokens) card vs "
          f"CPU from the same weights: max |diff| of {what} "
          + ", ".join(f"{e:.3g}" for e in err)
          + f" = {', '.join(f'{u:.2f}' for u in ulps)} bf16 ulps of the "
          f"largest value (bound {CARD_ULPS})", flush=True)


def cut_depth(cfg, params, n_layers: int):
    """The config and a view of the params with only the first
    ``n_layers`` stacked layers (every width kept)."""
    import dataclasses

    layers = _map_leaves(params["layers"], lambda t: t[:n_layers])
    return (dataclasses.replace(cfg, n_layers=n_layers),
            {**params, "layers": layers})


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def ssm_model_path(torch, build, serve, arch, dev="cuda", cfg=None,
                   smoke=False):
    """[ssm] (a) / (b): ``arch`` at full width (``cfg``'s depth) — random bf16
    weights from seed 0 drawn on the card leaf by leaf, one classic
    request of 512 + 64 tokens served with the launch counts set to 0
    just before and read just after (no spill, no tier kernel, no decode
    attention kernel, nothing stored) and its logits recorded; decode ==
    forward over the served sequence in bf16 (the served logits) and in
    f32 (the params cast, a cache in f32; greedy choices within the
    margin-aware bound); a full-width layer on the card against the CPU;
    for the hybrid also its prefill through the cache == its forward and
    the shared-block applications a pass runs.  Returns the params (the
    caller frees them after (c))."""
    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.models import layers, model
    from repro_torch.runtime import ServeEngine

    cfg = cfg or ARCHS[arch]
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev)
    _sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[ssm] {arch}: {n_params} parameters ({_allocated(torch, dev)} B "
          f"on the card) drawn in {time.perf_counter() - t0:.2f} s; peak "
          f"{_peak(torch, dev)} B", flush=True)
    served, step, step_s = [], ServeEngine._step, []

    def recorded(self, tokens, run):
        t = time.perf_counter()
        out = step(self, tokens, run)     # ends in a copy to the host
        step_s.append(time.perf_counter() - t)
        served.append(out)
        return out
    ServeEngine._step = recorded
    build.reset_launches()
    try:
        rep = serve(arch=arch, **{**SSM_SERVE, "smoke": smoke},
                    params=params, torch_device=dev, n_layers=cfg.n_layers)
        _sync(torch, dev)
    finally:
        ServeEngine._step = step
    launches = dict(build.LAUNCHES)
    toks = rep.tokens[0]
    if toks.shape != (1, 64) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"[ssm] {arch}: bad tokens {toks.shape}")
    if rep.spilled_pages or rep.readback_pages or rep.kv_logical_bytes or \
            rep.kv_stored_bytes or rep.tier_dram_read or rep.tier_link_out:
        raise AssertionError(f"[ssm] {arch}: the recurrent state reached the "
                             f"tier: {vars(rep)}")
    if any(launches.values()):
        raise AssertionError(f"[ssm] {arch}: a kernel launched while "
                             f"serving: {launches}")
    print(f"[ssm] {arch} served 512 + 64 tokens: wall tok/s {rep.tok_s:.3f} "
          f"({rep.wall_s:.3f} s: prefill of the 512-token prompt "
          f"{step_s[0]:.3f} s, a decode step {np.mean(step_s[1:]) * 1e3:.1f}"
          f" ms on average); peak allocated {_peak(torch, dev)} B; "
          f"spilled {rep.spilled_pages} pages, tier stored "
          f"{rep.kv_stored_bytes} B, link out {rep.tier_link_out} B; kernel "
          f"launches {sum(launches.values())} ({launches})", flush=True)

    # the served sequence: the served run's logits against a bf16 forward
    # over it; then the same in f32, where the GEMMs' summation order
    # cannot hide a fault of the cache
    prompt = np.random.default_rng(SSM_SERVE["seed"]).integers(
        0, cfg.vocab, (1, SSM_SERVE["prompt_len"])).astype(np.int32)
    seq = torch.from_numpy(np.concatenate([prompt, toks], 1)).to(dev)
    P = prompt.shape[1]
    pre, _, full, _ = decode_vs_forward(
        torch, cfg, params, seq, "tokens", P, dev, "ssm",
        steps=torch.from_numpy(np.concatenate(served)), greedy=False)
    layer_card_vs_cpu(torch, cfg, params, dev, "ssm")
    p32 = _map_leaves(params, lambda t: t.float())
    apps = ShapeRecorder(layers, "gqa_block", lambda *a, **kw: "calls")
    try:
        pre32, _, full32, _ = decode_vs_forward(
            torch, cfg, p32, seq, "tokens", P, dev, "ssm",
            dtype=torch.float32, noise=False)
    finally:
        layers.gqa_block = apps.original
    apps = apps.counts.get("calls", 0)
    del p32
    if cfg.family == "hybrid":
        # the forward, the prefill and the steps
        passes = 2 + seq.shape[1] - P
        per_pass = len(model.shared_applications(cfg))
        if apps != per_pass * passes:
            raise AssertionError(f"[ssm] {apps} shared-block calls for "
                                 f"{passes} passes of {per_pass}")
        for kind, got, want in (("bf16", pre, full), ("f32", pre32, full32)):
            diff = (got - want[:P]).abs()
            if bool((diff > 0.15 + 0.15 * want[:P].abs()).any()):
                raise AssertionError(f"[ssm] {arch}: {kind} prefill through "
                                     f"the cache != forward: "
                                     f"{float(diff.max())}")
            print(f"[ssm] {arch}: {kind} prefill of the {P}-token prompt "
                  f"through the rolling cache == forward at every prompt "
                  f"position, max |diff| {float(diff.max()):.4g}", flush=True)
        print(f"[ssm] {arch}: the shared block ran {per_pass} times a pass "
              f"(after layers {[i for i, _ in model.shared_applications(cfg)]}"
              f"), {apps} calls in {passes} passes", flush=True)
    return params


def hybrid_weights_check(torch, build, k_bitplane, params, dev="cuda"):
    """[ssm] (c): layer 0's in_proj of the hybrid (3584 x 14496 at full
    width) as four row blocks of falling importance (views FULL, FULL,
    MAN4, MAN2) through a ``WeightStore`` on the card and on a CPU tier,
    launch counts set to 0 just before the card's load and fetch and read
    just after: stored payloads, flags, receipts, stored bytes and
    fetched words identical; every fetched unit its source rounded to
    its view."""
    from repro_torch.runtime import WeightStore

    w = params["layers"]["in_proj"][0]
    rows = w.shape[0] // 4
    units = {f"in_proj.{i}": (w[i * rows:(i + 1) * rows], 4.0 - i)
             for i in range(4)}
    sizes = [s for u, _ in units.values() for s in _block_sizes(u.numel())]
    enc_slabs = _slabs(sizes, SLAB_ELEMS)
    dev = torch.device(dev)
    stores, words, recs, launches = {}, {}, {}, {}
    alone = None
    for where in (dev, torch.device("cpu")):
        store = WeightStore("trace", device=where)
        rec = Recorder(store.tier)
        on = {k: (u.to(where), imp) for k, (u, imp) in units.items()}
        build.reset_launches()
        t0 = time.perf_counter()
        store.put_many(on)
        _sync(torch, where)
        load_s = time.perf_counter() - t0
        load = dict(build.LAUNCHES)
        if where == dev:
            alone = ShapeRecorder(k_bitplane, "unpack_planes",
                                  lambda r, *a, **kw: r.shape[1] * 8)
        build.reset_launches()
        t0 = time.perf_counter()
        try:
            out = store.fetch_all()
            _sync(torch, where)
        finally:
            if where == dev:
                k_bitplane.unpack_planes = alone.original
        fetch_s = time.perf_counter() - t0
        fetch = dict(build.LAUNCHES)
        check_weight_words(torch, k_bitplane, store, on, out,
                           f"[ssm] in_proj on {where.type}")
        stores[where.type] = store
        words[where.type] = {k: v.view(torch.int16).cpu() for k, v in
                             out.items()}
        recs[where.type] = [_receipt_fields(r) for r in rec.recs]
        launches[where.type] = (load, fetch, load_s, fetch_s)
        del out, on
    card, cpu = stores[dev.type], stores["cpu"]
    if recs[dev.type] != recs["cpu"]:
        raise AssertionError("[ssm] in_proj: card receipts differ from the "
                             "CPU's")
    for key, blocks in cpu.tier._tensors.items():
        if [(b.payloads, b.flags) for b in card.tier._tensors[key]] != \
                [(b.payloads, b.flags) for b in blocks]:
            raise AssertionError(f"[ssm] in_proj: {key}'s stored bytes "
                                 "differ card vs CPU")
    if card.tier._tensors.keys() != cpu.tier._tensors.keys() or \
            vars(card.stats) != vars(cpu.stats):
        raise AssertionError("[ssm] in_proj: stored units or stats differ")
    if any(not torch.equal(words[dev.type][k], words["cpu"][k])
           for k in units):
        raise AssertionError("[ssm] in_proj: fetched words differ card vs "
                             "CPU")
    load, fetch, load_s, fetch_s = launches[dev.type]
    groups: dict = {}
    for name, (u, _) in units.items():
        groups.setdefault(card.view_for(name), []).extend(
            _block_sizes(u.numel()))
    dec_slabs = sum(_slabs(g, DECODE_ELEMS) for g in groups.values())
    n_alone = sum(alone.counts.values())
    if dev.type == "cuda" and not (
            load["bitplane_pack"] == enc_slabs
            and 0 < load["lz4_prep"] == load["lz4_match"] <= enc_slabs
            and fetch["bitplane_unpack"] == n_alone == dec_slabs
            and not any(v for k, v in load.items() if k not in
                        ("bitplane_pack", "lz4_prep", "lz4_match"))
            and not any(v for k, v in fetch.items()
                        if k != "bitplane_unpack")):
        raise AssertionError(f"[ssm] in_proj launches: load {load} for "
                             f"{enc_slabs} encode slabs, fetch {fetch} "
                             f"({n_alone} standalone) for {dec_slabs} "
                             "decode slabs")
    st = card.stats
    print(f"[ssm] (c) layer 0's in_proj {tuple(w.shape)} as 4 units (views "
          f"{[card.view_for(n).name for n in units]}) through a WeightStore: "
          f"card == CPU tier (payloads, flags, receipts, stats, fetched "
          f"words), stored {st.dram_bytes_stored} B for "
          f"{st.raw_bytes_stored} B (ratio "
          f"{st.raw_bytes_stored / st.dram_bytes_stored:.4f}); every unit == "
          f"its source rounded to its view; card launches: load "
          f"bitplane_pack {load['bitplane_pack']}, lz4_prep "
          f"{load['lz4_prep']}, lz4_match {load['lz4_match']} over "
          f"{enc_slabs} encode slabs ({load_s:.3f} s); fetch standalone "
          f"bitplane_unpack {n_alone} over {dec_slabs} decode slabs "
          f"({fetch_s:.3f} s); CPU tier load {launches['cpu'][2]:.3f} s, "
          f"fetch {launches['cpu'][3]:.3f} s", flush=True)


def ssm_path(torch, build, k_bitplane, serve, dev="cuda", cfgs=None,
             smoke=False):
    """[ssm]: (a) falcon-mamba-7b and (b) zamba2-7b at full width, their
    depth cut to :data:`SSM_LAYERS` (``cfgs`` overrides them for a
    rehearsal), then (c) zamba2's in_proj through the tier; each model's
    params freed after it."""
    import dataclasses

    from repro_torch.configs import ARCHS

    dev = torch.device(dev)
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg = (cfgs or {}).get(arch) or dataclasses.replace(
            ARCHS[arch], n_layers=SSM_LAYERS[arch])
        params = ssm_model_path(torch, build, serve, arch, dev, cfg, smoke)
        if cfg.family == "hybrid":
            hybrid_weights_check(torch, build, k_bitplane, params, dev)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[ssm] {arch} done in {time.perf_counter() - t0:.1f} s; peak "
              f"allocated {_peak(torch, dev)} B; params freed: "
              f"{_allocated(torch, dev)} B allocated", flush=True)


def check_llava_attention(torch, k_attn, results):
    """Decode attention at llava-next-34b's shape — q (1, 56, 128) over a
    bf16 (1, 640, 8, 128) cache, a group of 7 query heads a KV head — at
    the last step's valid length and the first, one position, and the
    whole cache: within the f32 tolerance of its plain version, bit-equal
    across two calls; timed beside the plain version, the bound and the
    fastest SDPA backend (row ``decode_attn_llava``; [frontends] fills in
    its launches and checks it ran this shape)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    q = torch.randn((1, LLAVA_HEADS, LLAVA_HD), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, LLAVA_SEQ, LLAVA_KV, LLAVA_HD), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    errs = []
    for valid in (LLAVA_VALID, 513, 1, LLAVA_SEQ):
        got = k_attn.decode_attention(q, k, v, valid)
        want = k_attn.decode_attention_plain(q, k, v, valid)
        again = k_attn.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= ATOL + RTOL * want.abs()).all()):
            raise AssertionError(f"decode_attn at llava's shape, valid_len "
                                 f"{valid}: max error {float(err.max())}")
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attn at llava's shape, valid_len "
                                 f"{valid}: differs between two calls")
        errs.append(float(err.max()))
    b, by = attn_bound(LLAVA_VALID, LLAVA_HEADS, LLAVA_KV, LLAVA_HD)
    sdpa_ms = sdpa_backends(torch, q, k, v, LLAVA_VALID)
    results["decode_attn_llava"] = dict(
        name="decode_attn_llava", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:36",
        max_abs_err=max(errs), launches=0,
        **timed(torch, lambda: k_attn.decode_attention(q, k, v,
                                                       LLAVA_VALID)),
        plain_ms=timed(torch, lambda: k_attn.decode_attention_plain(
            q, k, v, LLAVA_VALID))["ms"],
        bound_ms=b, bound_by=by,
        library_ms=min(sdpa_ms.values()) if sdpa_ms else None)
    print("[kernel] SDPA at llava-next-34b's decode shape (56 / 8 heads, hd "
          "128, 576 positions), by backend: "
          + "; ".join(f"{name} {ms * 1e3:.2f} us"
                      for name, ms in sdpa_ms.items()), flush=True)


def frontends_path(torch, build, results, dev="cuda", cfgs=None):
    """[frontends]: (a) hubert-xlarge at full width and depth — one
    forward of seeded embeds (1, 512, 1280) without a cache, the logits
    finite and of their shape, a full-width layer on the card against
    the CPU; (b) llava-next-34b at full width, its depth cut to
    :data:`LLAVA_LAYERS` — a 512-embed prompt, then 64 teacher-forced
    embed steps, decode == forward, with the launch counts set to 0 just
    before and read just after: decode attention once a layer a step, at
    llava's shape.  The params of each freed after it."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.models import layers, model

    dev = torch.device(dev)
    cfgs = cfgs or {HUBERT_ARCH: ARCHS[HUBERT_ARCH],
                    LLAVA_ARCH: dataclasses.replace(ARCHS[LLAVA_ARCH],
                                                    n_layers=LLAVA_LAYERS)}
    rng = np.random.default_rng(22)

    def embeds(cfg, n):
        return torch.from_numpy(rng.standard_normal(
            (1, n, cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)

    for arch, cfg in cfgs.items():
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        params = model.init_params(cfg, seed=0, device=dev)
        _sync(torch, dev)
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[frontends] {arch} ({cfg.n_layers} layers, d {cfg.d_model}): "
              f"{n_params} parameters ({_allocated(torch, dev)} B on the "
              f"card) drawn in {time.perf_counter() - t0:.2f} s", flush=True)
        if not cfg.causal:
            x = embeds(cfg, FRONT_TOKENS)
            t1 = time.perf_counter()
            with torch.no_grad():
                logits, none = model.forward(cfg, params, {"embeds": x})
            _sync(torch, dev)
            if none is not None or tuple(logits.shape) != \
                    (1, FRONT_TOKENS, cfg.vocab) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"[frontends] {arch}: logits "
                                     f"{tuple(logits.shape)} not finite")
            print(f"[frontends] {arch}: one forward of {FRONT_TOKENS} "
                  f"frame embeds, no cache: logits {tuple(logits.shape)} "
                  f"finite, up to {float(logits.abs().max()):.3g}; "
                  f"{time.perf_counter() - t1:.3f} s wall", flush=True)
            del logits
            layer_card_vs_cpu(torch, cfg, params, dev, "frontends", seq=64)
        else:
            x = embeds(cfg, LLAVA_VALID)
            shapes = ShapeRecorder(layers, "decode_attention", lambda q, k,
                                   *a, **kw: f"{tuple(q.shape)}x"
                                   f"{tuple(k.shape)}")
            build.reset_launches()
            try:
                decode_vs_forward(torch, cfg, params, x, "embeds",
                                  FRONT_TOKENS, dev, "frontends")
                _sync(torch, dev)
            finally:
                layers.decode_attention = shapes.original
            launches = dict(build.LAUNCHES)
            n_steps = LLAVA_VALID - FRONT_TOKENS
            want = {f"{(1, LLAVA_HEADS, LLAVA_HD)}x"
                    f"{(1, LLAVA_SEQ, LLAVA_KV, LLAVA_HD)}":
                    n_steps * cfg.n_layers}
            if dev.type == "cuda" and (
                    launches["decode_attn"] != n_steps * cfg.n_layers
                    or shapes.counts != want
                    or sum(launches.values()) != launches["decode_attn"]):
                raise AssertionError(f"[frontends] {arch}: launches "
                                     f"{launches}, attention shapes "
                                     f"{shapes.counts}")
            results["decode_attn_llava"]["launches"] = \
                launches["decode_attn"]
            print(f"[frontends] {arch}: decode attention launches "
                  f"{launches['decode_attn']} ({n_steps} steps x "
                  f"{cfg.n_layers} layers, q x cache {shapes.counts}); "
                  f"peak allocated {_peak(torch, dev)} B", flush=True)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[frontends] {arch} done in {time.perf_counter() - t0:.1f} "
              f"s; params freed: {_allocated(torch, dev)} B allocated",
              flush=True)


# [train]: training on the card, each run's step captured once as a CUDA
# graph and replayed (``TrainGraph``).  qwen2-0.5b at full width and depth
# takes train steps at TRAIN_4K's sequence length; two steps card vs CPU;
# the graph against an all-eager run, a checkpoint and resume;
# deepseek-v2-lite-16b's MoE at full width; the train_100m twin.
# Training launches no kernel of the port: the
# reference's train step reaches no Pallas kernel (its attention over the
# prompt, MoE and scans are jnp), and the port's attends in plain PyTorch.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SEQ = 4096             # TRAIN_4K's sequence length
TRAIN_BATCH = 2              # TRAIN_4K's global batch of 256, cut to 2
TRAIN_STEPS = 4
CMP_LAYERS, CMP_SEQ, CMP_BATCH = 2, 256, 2       # (b) card vs CPU
RESUME_LAYERS, RESUME_SEQ, RESUME_BATCH = 2, 512, 2   # (c)
MOE_TRAIN_ARCH = "deepseek-v2-lite-16b"
MOE_TRAIN_LAYERS = 4         # the dense layer and 3 of 26 MoE layers
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 4096, 1, 2
TRAIN_100M_STEPS = 100       # of the twin's default 300: the time limit
# (b)'s bounds: the two devices sum bf16 GEMMs in other orders
CMP_LOSS_ATOL = 1e-2         # |loss card - loss CPU|
CMP_GRAD_RTOL = 0.05         # each leaf's gradient, relative L2
CMP_PARAM_SHARE = 0.99       # updated params bit-equal, at least this share


def cut_arch(arch: str, n_layers: int) -> str:
    """Register ``arch`` cut to ``n_layers`` layers (every width kept) in
    the port's ``ARCHS`` under ``<arch>-<n>l``, for ``train``."""
    import dataclasses

    from repro_torch.configs import ARCHS

    name = f"{arch}-{n_layers}l"
    ARCHS[name] = dataclasses.replace(ARCHS[arch], name=name,
                                      n_layers=n_layers)
    return name


def _history_lines(tag: str, out, tokens: int):
    graphed = out["capture_s"] is not None
    for i, h in enumerate(out["history"]):
        how = ("eager" if not graphed else "the eager warm-up" if i == 0
               else "the capture + its first replay" if i == 1
               else "replayed")
        print(f"[train] {tag} step {h['step']} ({how}): {h['seconds']:.3f} "
              f"s wall, {tokens / h['seconds']:.1f} tokens/s, loss "
              f"{h['loss']:.5f}, grad_norm {h['grad_norm']:.5f}, lr "
              f"{h['lr']:.4g}", flush=True)
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"[train] {tag}: step {h['step']} {h}")


def _graph_line(torch, out, dev) -> str:
    """A ``train`` run's warm-up and capture host seconds, and the card's
    peak allocated and reserved memory since the last reset."""
    if out["capture_s"] is None:
        raise AssertionError(f"[train] no capture on {dev}")
    reserved = torch.cuda.max_memory_reserved(dev)
    return (f"warm-up step {out['warmup_s']:.3f} s, capture "
            f"{out['capture_s']:.3f} s (host); peak allocated "
            f"{_peak(torch, dev)} B, peak reserved {reserved} B, reserved "
            f"now {torch.cuda.memory_reserved(dev)} B")


def profile_replayed_step(torch, cfg, out, dev, batch):
    """Two more steps of (a)'s state through a fresh ``TrainGraph`` (its
    warm-up, its capture and first replay), then one replay under
    ``torch.profiler`` (device activity only), read from the raw events
    as [graph] (c) reads them: the step's wall, the device's busy share
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainGraph

    step, _ = make_train_step(cfg, grad_compression=True)
    run = TrainGraph(step, out["params"], out["opt_state"], out["err"])
    for _ in range(2):
        float(run(batch)["loss"])
    _sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(run(batch)["loss"])
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    by_name, n_events = device_events(prof)
    busy = sum(ns for ns, _ in by_name.values()) / 1e9
    top = sorted(((k, ns / 1e3, n) for k, (ns, n) in by_name.items()),
                 key=lambda t: -t[1])[:5]
    print(f"[train] (a) one replayed {cfg.name} step of "
          f"{batch['tokens'].numel()} tokens under torch.profiler: wall "
          f"{wall:.3f} s, device busy {busy:.3f} s ({100 * busy / wall:.1f}"
          f"%), host-bound (wall not busy) {wall - busy:.3f} s; "
          f"{sum(n for _, n in by_name.values())} kernels and copies on the "
          f"card ({n_events} events); capture {run.capture_s:.3f} s, warm-up"
          f" {run.warmup_s:.3f} s (host); top: "
          + "; ".join(f"{k[:50]} {us / 1e3:.1f} ms x{n}" for k, us, n in top),
          flush=True)


def profile_train_step(torch, cfg, out, dev, tokens):
    """One more train step of (a)'s state, its phases as ``train_step``
    runs them — forward (``lm_loss``), backward (``autograd.grad``, which
    recomputes each layer's forward under remat), compression, the
    optimizer — with CUDA events between them (each phase's span on the
    device's timeline, idle gaps included), under ``torch.profiler``
    (device activity only) for the kernels' busy time: the busy share of
    the step's wall time, the rest host-bound, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import default_adamw
    from repro_torch.models.model import lm_loss
    from repro_torch.optim import update
    from repro_torch.optim.grad_compress import compress_grads

    params, state, err = out["params"], out["opt_state"], out["err"]
    leaves = []
    _map_leaves(params, leaves.append)
    batch = {"tokens": tokens, "labels": tokens}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    _sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        loss = lm_loss(cfg, params, batch)
        ev[1].record()
        found = iter(torch.autograd.grad(loss, leaves))
        ev[2].record()
        grads = _map_leaves(params, lambda p: next(found))
        grads, err = compress_grads(grads, err)
        ev[3].record()
        update(default_adamw(cfg), grads, state, params)
        ev[4].record()
        float(loss.detach())
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    spans = {name: ev[i].elapsed_time(ev[i + 1]) / 1e3 for i, name in
             enumerate(("forward", "backward", "compress", "optimizer"))}
    kernels = [(k, ns / 1e3, n) for k, (ns, n) in
               device_events(prof)[0].items()]
    busy = sum(us for _, us, _ in kernels) / 1e6
    top = sorted(kernels, key=lambda t: -t[1])[:5]
    print(f"[train] one {cfg.name} step of {tokens.numel()} tokens under "
          f"torch.profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), host-bound (wall not busy) "
          f"{wall - busy:.3f} s; on the device's timeline: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
          + f"; {sum(n for *_, n in kernels)} kernels and copies; top: "
          + "; ".join(f"{k[:50]} {us / 1e3:.1f} ms x{n}" for k, us, n in top),
          flush=True)


def train_full_width(torch, train, dev, arch=TRAIN_ARCH,
                     seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                     smoke=False):
    """(a): ``arch`` at full width and depth, random bf16 weights from
    seed 0, remat as its config says, grad compression on, f32 moments:
    ``steps`` steps of ``train`` at ``seq`` x ``batch`` (the first the
    warm-up before the capture, the rest replayed); per step wall,
    tokens/s, loss, grad_norm, lr; the warm-up and capture seconds, peak
    allocated and reserved; every loss and norm finite, grad_norm > 0,
    every leaf changed from its initial draw; then one eager step
    profiled by phase and one replayed step profiled."""
    import numpy as np

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCHS[arch]) if smoke else ARCHS[arch]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = train(arch=arch, steps=steps, smoke=smoke, seq_len=seq,
                global_batch=batch, grad_compression=True, seed=0,
                device=dev, log_every=steps)
    _sync(torch, dev)
    n_params = sum(t.numel() for _, t in leaves_with_paths(out["params"]))
    graph = _graph_line(torch, out, dev) if dev.type == "cuda" else \
        "no capture on the CPU"
    print(f"[train] (a) {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters, remat {cfg.remat}, {steps} steps of "
          f"{batch} x {seq} tokens in {time.perf_counter() - t0:.2f} s; "
          f"{graph}", flush=True)
    _history_lines("(a)", out, batch * seq)
    init = dict(leaves_with_paths(model.init_params(cfg, seed=0,
                                                    device=dev)))
    shares = {}
    for path, p in leaves_with_paths(out["params"]):
        p0 = init[path]
        shares[path] = float((p.detach() != p0).float().mean())
    del init
    if min(shares.values()) <= 0:
        raise AssertionError(f"[train] (a): leaves unchanged: "
                             f"{[k for k, v in shares.items() if v <= 0]}")
    print(f"[train] (a) every leaf changed; the share of elements changed "
          f"per leaf: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    shares.items()), flush=True)
    tokens = torch.from_numpy(np.ascontiguousarray(
        _stream(cfg, seq, batch).batch_at(steps)["tokens"])).to(dev)
    if dev.type == "cuda":
        profile_train_step(torch, cfg, out, dev, tokens)
        profile_replayed_step(torch, cfg, out, dev,
                              {"tokens": tokens, "labels": tokens})
    del out


def _stream(cfg, seq, batch, seed=0):
    from repro_torch.data import DataConfig, ShardedTokenStream

    return ShardedTokenStream(DataConfig(cfg.vocab, seq, batch, seed=seed))


def _ulps_apart(torch, a, b):
    """Per element, |a - b| in bf16 ulps of the larger magnitude."""
    mag = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(1e-30)
    return (a.float() - b.float()).abs() / torch.exp2(
        torch.floor(torch.log2(mag)) - 7)


def train_card_vs_cpu(torch, dev, cfg=None):
    """(b): the same weights and batches on the card and on the CPU —
    qwen2-0.5b at full width, its depth cut to :data:`CMP_LAYERS`,
    :data:`CMP_BATCH` x :data:`CMP_SEQ` tokens: two steps through a
    ``TrainGraph`` (on the card the first its warm-up, the second a
    replay): the first step's gradient of each leaf (relative L2; taken
    where the step hands it to the compression), each step's loss and
    grad norm, and the params after them
    (the share bit-equal, the largest difference in bf16 ulps) within
    :data:`CMP_LOSS_ATOL`, :data:`CMP_GRAD_RTOL`, :data:`CMP_PARAM_SHARE`
    and, for the params that differ, 1 ulp or 2 x the steps' lr (a
    near-zero gradient's sign may flip between the devices, and a step
    moves an element by at most lr (1 + wd |p|))."""
    import numpy as np

    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.launch.train import TrainGraph
    from repro_torch.models import model
    from repro_torch.optim import init as opt_init
    from repro_torch.optim.grad_compress import init_error_feedback
    from repro_torch.tree import leaves_with_paths

    cfg = cfg or dataclasses.replace(ARCHS[TRAIN_ARCH], n_layers=CMP_LAYERS)
    data = _stream(cfg, CMP_SEQ, CMP_BATCH)
    toks = [np.ascontiguousarray(data.batch_at(i)["tokens"])
            for i in range(2)]
    params = model.init_params(cfg, seed=0, device=dev)
    res, secs = {}, {}
    compress = steps.compress_grads

    def first_grads(grads, err):
        if not grads_seen:
            grads_seen.append(_map_leaves(grads, lambda g: g.detach().clone()))
        return compress(grads, err)

    for where in ("card", "cpu"):
        t0 = time.perf_counter()
        d = dev if where == "card" else torch.device("cpu")
        p = _map_leaves(params, lambda t: t.detach().to(d, copy=True))
        batches = [{"tokens": t, "labels": t} for t in
                   (torch.from_numpy(a).to(d) for a in toks)]
        step, ocfg = steps.make_train_step(cfg, grad_compression=True)
        run = TrainGraph(step, p, opt_init(ocfg, p), init_error_feedback(p))
        grads_seen = []
        steps.compress_grads = first_grads
        try:
            metrics = [{k: float(v) for k, v in run(b).items()}
                       for b in batches]
        finally:
            steps.compress_grads = compress
        if (run.graph is not None) != (d.type == "cuda"):
            raise AssertionError(f"[train] (b) {where}: graph {run.graph}")
        res[where] = (metrics, grads_seen[0], run.params)
        _sync(torch, dev)
        secs[where] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (mc, gc, pc), (mh, gh, ph) = res["card"], res["cpu"]
    lr = sum(m["lr"] for m in mh)
    worst_g, share, worst_u, n_far = 0.0, [], 0.0, 0
    gh, ph = dict(leaves_with_paths(gh)), dict(leaves_with_paths(ph))
    for path, a in leaves_with_paths(gc):    # compared on the card
        a, b = a.float(), gh[path].to(dev).float()
        worst_g = max(worst_g, float((a - b).norm() / b.norm().clamp_min(
            1e-30)))
    for path, a in leaves_with_paths(pc):
        a, b = a.detach(), ph[path].detach().to(dev)
        eq = a.view(torch.int16) == b.view(torch.int16) \
            if a.dtype == torch.bfloat16 else a == b
        share.append((float(eq.float().sum()), eq.numel()))
        u = _ulps_apart(torch, a, b)
        worst_u = max(worst_u, float(u.max()))
        far = (u > 1) & ((a.float() - b.float()).abs() > 2 * lr)
        n_far += int(far.sum())
    bit_share = sum(s for s, _ in share) / sum(n for _, n in share)
    dl = max(abs(a["loss"] - b["loss"]) for a, b in zip(mc, mh))
    dn = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
             for a, b in zip(mc, mh))
    print(f"[train] (b) card vs CPU ({cfg.n_layers} layers at full width, "
          f"{CMP_BATCH} x {CMP_SEQ} tokens; card {secs['card']:.1f} s, CPU "
          f"{secs['cpu']:.1f} s, comparison {time.perf_counter() - t0:.1f} "
          f"s): the first step's worst leaf gradient relative L2 "
          f"{worst_g:.4g} (bound {CMP_GRAD_RTOL}); two steps, the card's "
          f"second replayed: losses {[m['loss'] for m in mc]} vs "
          f"{[m['loss'] for m in mh]}, largest |diff| {dl:.3g} (bound "
          f"{CMP_LOSS_ATOL}); grad norms' largest relative diff {dn:.3g} "
          f"(bound {CMP_GRAD_RTOL}); params after both bit-equal "
          f"{bit_share:.6f} (bound {CMP_PARAM_SHARE}), largest difference "
          f"{worst_u:.3g} bf16 ulps, {n_far} elements more than 1 ulp and "
          f"2 x the steps' lr apart (bound 0)", flush=True)
    if dl > CMP_LOSS_ATOL or worst_g > CMP_GRAD_RTOL or dn > CMP_GRAD_RTOL \
            or bit_share < CMP_PARAM_SHARE or n_far \
            or [m["lr"] for m in mc] != [m["lr"] for m in mh]:
        raise AssertionError("[train] (b) card vs CPU past its bounds")


def _same_bytes(torch, a, b) -> bool:
    """Whether two tensors on one device have the same dtype, shape and
    bytes (compared where they lie)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8))


def eager_train(torch, cfg, steps, seq, batch, dev, seed=0):
    """``train``'s loop with no graph: the plain ``make_train_step`` step
    called eagerly at every step, from ``train``'s initial state, on its
    token stream.  Returns the per-step ``(loss, grad_norm, lr)`` and the
    final state as a checkpoint stores it."""
    import numpy as np

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model
    from repro_torch.optim import init as opt_init
    from repro_torch.optim.grad_compress import init_error_feedback

    step, ocfg = make_train_step(cfg, grad_compression=True)
    params = model.init_params(cfg, seed=seed, device=dev)
    state, err = opt_init(ocfg, params), init_error_feedback(params)
    data, history = _stream(cfg, seq, batch, seed), []
    for i in range(steps):
        toks = torch.from_numpy(np.ascontiguousarray(
            data.batch_at(i)["tokens"])).to(dev)
        params, state, err, m = step(params, state, err,
                                     {"tokens": toks, "labels": toks})
        history.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
    return history, {"params": params, "opt": state, "err": err}


def _state_of(out) -> dict:
    return {"params": out["params"], "opt": out["opt_state"],
            "err": out["err"]}


def _differing(torch, got: dict, want: dict) -> list:
    """The leaves of ``got`` whose dtype, shape or bytes differ from
    ``want``'s."""
    from repro_torch.tree import leaves_with_paths

    want = dict(leaves_with_paths(want))
    return [path for path, t in leaves_with_paths(got)
            if not _same_bytes(torch, t, want[path])]


def train_resume(torch, train, dev, arch=None, smoke=False):
    """(c): under ``torch.use_deterministic_algorithms(True)``
    (``CUBLAS_WORKSPACE_CONFIG`` is set at the top of :func:`main`, before
    the first cuBLAS call): 4 steps of ``train`` (a warm-up, then a
    capture and three replays) against the same 4 steps all eager
    (:func:`eager_train`) — losses, grad norms, lrs and the final
    params, moments, step and residuals bit for bit; then 2 steps, a
    checkpoint, a restore into fresh state and 2 more steps, the resumed
    run capturing again: the restored state byte-identical to the saved
    one, the data step resumed where it stopped, the resumed losses and
    final state equal to the straight run's."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.tree import leaves_with_paths

    arch = arch or cut_arch(TRAIN_ARCH, RESUME_LAYERS)
    cfg = smoke_config(ARCHS[arch]) if smoke else ARCHS[arch]
    kw = dict(arch=arch, smoke=smoke, seq_len=RESUME_SEQ,
              global_batch=RESUME_BATCH, ckpt_every=100, seed=0, device=dev,
              log_every=100)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        straight = train(steps=4, **kw)
        eager, eager_state = eager_train(torch, cfg, 4, RESUME_SEQ,
                                         RESUME_BATCH, dev)
        with tempfile.TemporaryDirectory(prefix="train_resume_") as ckpt:
            first = train(steps=2, ckpt_dir=ckpt, **kw)
            saved = _state_of(first)
            restored, manifest = CheckpointManager(ckpt).restore(
                saved, device=dev)
            resumed = train(steps=4, ckpt_dir=ckpt, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    _sync(torch, dev)
    graphed = [(h["loss"], h["grad_norm"], h["lr"])
               for h in straight["history"]]
    off = _differing(torch, _state_of(straight), eager_state)
    if graphed != eager or off:
        raise AssertionError(f"[train] (c) graph vs eager: history {graphed}"
                             f" vs {eager}, leaves differ {off}")
    captures = [r["capture_s"] for r in (straight, first, resumed)]
    if dev.type == "cuda" and None in captures:
        raise AssertionError(f"[train] (c) a run captured nothing: "
                             f"{captures}")
    bad = _differing(torch, restored, saved)
    if bad or manifest["step"] != 2 or resumed["start_step"] != 2:
        raise AssertionError(f"[train] (c) restore: leaves differ {bad}, "
                             f"manifest {manifest}, resumed from "
                             f"{resumed['start_step']}")
    off = _differing(torch, _state_of(resumed), _state_of(straight))
    if resumed["losses"] != straight["losses"][2:] or off:
        raise AssertionError(f"[train] (c) resumed losses "
                             f"{resumed['losses']} != straight "
                             f"{straight['losses'][2:]}, or leaves differ "
                             f"{off}")
    n = len(leaves_with_paths(saved))
    print(f"[train] (c) {arch}, {RESUME_BATCH} x {RESUME_SEQ} tokens, "
          f"deterministic algorithms: 4 steps through the graph (captures "
          f"{['%.3f s' % c if c else None for c in captures]} for the "
          f"straight, first and resumed runs) == 4 all eager: losses "
          f"{straight['losses']}, grad norms, lrs and the {n} leaves of "
          f"the final state bit for bit; 2 + save + restore + 2: the {n} "
          f"restored leaves byte-identical to the saved state, data resumed "
          f"at step {resumed['start_step']}, losses {resumed['losses']} and "
          f"the final state == the straight run's "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def train_moe(torch, train, dev, arch=None, smoke=False):
    """(d): deepseek-v2-lite-16b at full width, its depth cut to the dense
    layer and 3 MoE layers, :data:`MOE_TRAIN_STEPS` steps of
    ``MOE_TRAIN_BATCH`` x ``MOE_TRAIN_SEQ`` tokens: per step the aux
    loss (the forward's, summed over the MoE layers), the share of
    (token, choice) pairs the capacity dropped, the loss, the capture's
    seconds and the peak memory.  The forward runs in Python twice on a
    card, for the warm-up (step 0) and for the capture: what the capture
    records are the graph's own tensors, which each replay rewrites, so
    with 2 steps they hold step 1's."""
    from repro_torch.models import layers, model
    from repro_torch.tree import leaves_with_paths

    arch = arch or cut_arch(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS)
    rec = {"aux": [], "drop": [], "pairs": [], "active": False}
    fwd, slots = model.forward_with_aux, layers.capacity_slots

    def recording_forward(*a, **kw):
        rec["active"] = True
        rec["drop"].append([])
        try:
            out = fwd(*a, **kw)
        finally:
            rec["active"] = False
        rec["aux"].append(out[2].detach())
        return out

    def recording_slots(experts, n_experts, cap):
        pos, keep = slots(experts, n_experts, cap)
        if rec["active"]:      # the forward; not remat's recompute
            rec["drop"][-1].append(((~keep).sum(), keep.numel()))
        return pos, keep

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model.forward_with_aux, layers.capacity_slots = (recording_forward,
                                                     recording_slots)
    t0 = time.perf_counter()
    try:
        out = train(arch=arch, steps=MOE_TRAIN_STEPS, smoke=smoke,
                    seq_len=MOE_TRAIN_SEQ, global_batch=MOE_TRAIN_BATCH,
                    grad_compression=True, seed=0, device=dev,
                    log_every=MOE_TRAIN_STEPS)
    finally:
        model.forward_with_aux, layers.capacity_slots = fwd, slots
    _sync(torch, dev)
    n_params = sum(t.numel() for _, t in leaves_with_paths(out["params"]))
    if len(rec["aux"]) != MOE_TRAIN_STEPS:
        raise AssertionError(f"[train] (d) {len(rec['aux'])} forwards "
                             f"recorded for {MOE_TRAIN_STEPS} steps")
    graph = _graph_line(torch, out, dev) if dev.type == "cuda" else \
        "no capture on the CPU"
    print(f"[train] (d) {arch}: {n_params} parameters, {MOE_TRAIN_STEPS} "
          f"steps of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens in "
          f"{time.perf_counter() - t0:.2f} s; {graph}", flush=True)
    _history_lines("(d)", out, MOE_TRAIN_BATCH * MOE_TRAIN_SEQ)
    for h, aux, drops in zip(out["history"], rec["aux"], rec["drop"]):
        dropped = sum(int(d) for d, _ in drops)
        pairs = sum(n for _, n in drops)
        aux = float(aux)
        if not math.isfinite(aux) or aux <= 0 or not drops:
            raise AssertionError(f"[train] (d) aux {aux}, {len(drops)} MoE "
                                 f"layers")
        print(f"[train] (d) step {h['step']}: aux loss {aux:.5f} over "
              f"{len(drops)} MoE layers, capacity dropped {dropped} of "
              f"{pairs} (token, choice) pairs ({dropped / pairs:.4f}), loss "
              f"{h['loss']:.5f}", flush=True)
    del out


def train_100m_path(torch, dev):
    """(e): the ``train_100m`` twin on the card, :data:`TRAIN_100M_STEPS`
    steps, every one after the first replayed; its own assertion (at 100
    steps or more the loss ends more than 0.5 below its start); the
    capture's seconds and the peak memory."""
    import contextlib
    import io

    from repro_torch.examples import train_100m

    argv = ["--steps", str(TRAIN_100M_STEPS)]
    if dev.type == "cpu":
        argv.append("--cpu")
    buf = io.StringIO()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = train_100m.main(argv)
    _sync(torch, dev)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[train] (e) train_100m | {line}", flush=True)
    secs = [h["seconds"] for h in out["history"]]
    graph = _graph_line(torch, out, dev) if dev.type == "cuda" else \
        "no capture on the CPU"
    print(f"[train] (e) train_100m: {len(secs)} steps in "
          f"{time.perf_counter() - t0:.1f} s, median step "
          f"{statistics.median(secs) * 1e3:.1f} ms (first {secs[0]:.3f} s); "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; {graph}",
          flush=True)


def train_path(torch, build, dev="cuda"):
    """[train]: (a)–(e), the launch counts set to 0 before each and read
    after: no kernel of the port may launch."""
    from repro_torch.launch.train import train

    dev = torch.device(dev)
    for part, fn in (
            ("(a)", lambda: train_full_width(torch, train, dev)),
            ("(b)", lambda: train_card_vs_cpu(torch, dev)),
            ("(c)", lambda: train_resume(torch, train, dev)),
            ("(d)", lambda: train_moe(torch, train, dev)),
            ("(e)", lambda: train_100m_path(torch, dev))):
        t0 = time.perf_counter()
        build.reset_launches()
        fn()
        if any(build.LAUNCHES.values()):
            raise AssertionError(f"[train] {part} launched a kernel of the "
                                 f"port: {dict(build.LAUNCHES)}")
        gc.collect()    # remat's reference cycles hold a step's tensors
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[train] {part} done in {time.perf_counter() - t0:.1f} s; "
              f"{_allocated(torch, dev)} B allocated", flush=True)


MESH_ARCH = "qwen2-0.5b"
MESH_LAYERS = 4              # [mesh] (a), (c): the first 4 of its 24 layers
MESH_SEQ, MESH_BATCH = 512, 2
MESH_PP_BATCH = 4            # (c): 4 rows, so 4 microbatches split them
MESH_RANKS = 4               # (d): gloo CPU ranks at (data, model) (2, 2)
MESH_SMOKE_SEQ, MESH_SMOKE_BATCH = 32, 4
MESH_RANK_TIMEOUT = 240      # seconds (d)'s ranks may take, spawn included
PP_TOL = 3e-2                # (c) pipelined prefill vs forward


def _group_of_one(torch, dev, tmp):
    """A process group of this process alone: NCCL over a ``FileStore``
    on the card, gloo on the CPU."""
    import torch.distributed as dist

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1), rank=0, world_size=1)


def _whole(torch, tree):
    from repro_torch.models.sharding import full
    from repro_torch.tree import leaves_with_paths

    return {k: full(v).detach() for k, v in leaves_with_paths(tree)}


def _state_diff(torch, a, b, lr_sum: float) -> dict:
    """Params ``a`` against ``b``: the share bit-equal, the largest
    difference in bf16 ulps and the elements more than 1 ulp and 2 x
    ``lr_sum`` apart."""
    same = total = far = 0
    worst = 0.0
    for k, x in a.items():
        y = b[k]
        eq = x.view(torch.int16) == y.view(torch.int16) \
            if x.dtype == torch.bfloat16 else x == y
        same, total = same + int(eq.sum()), total + eq.numel()
        u = _ulps_apart(torch, x, y)
        worst = max(worst, float(u.max()))
        far += int(((u > 1) & ((x.float() - y.float()).abs()
                               > 2 * lr_sum)).sum())
    return {"share": same / total, "ulps": worst, "far": far}


def mesh_train_vs_plain(torch, train, dev, mesh, arch=None, smoke=False,
                        seq=MESH_SEQ, batch=MESH_BATCH):
    """(a): two train steps with ``mesh=`` (a world of one; eager)
    against the same two without (on a card the second replayed), under
    deterministic algorithms: losses and params bit-equal (a world of one
    reorders no sum), else within [train] (b)'s bounds."""
    arch = arch or cut_arch(MESH_ARCH, MESH_LAYERS)
    kw = dict(arch=arch, steps=2, smoke=smoke, seq_len=seq,
              global_batch=batch, grad_compression=True, seed=0,
              device=dev, log_every=100)
    torch.use_deterministic_algorithms(True)
    try:
        plain = train(**kw)
        want = _whole(torch, plain["params"])
        del plain["params"], plain["opt_state"], plain["err"]
        t0 = time.perf_counter()
        meshed = train(mesh=mesh, **kw)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    if meshed["capture_s"] is not None or (
            dev.type == "cuda") != (plain["capture_s"] is not None):
        raise AssertionError(f"[mesh] (a) captures: mesh "
                             f"{meshed['capture_s']}, without "
                             f"{plain['capture_s']}")
    got = _whole(torch, meshed["params"])
    d = _state_diff(torch, got, want, sum(h["lr"] for h in meshed["history"]))
    dl = max(abs(a - b) for a, b in zip(meshed["losses"], plain["losses"]))
    how = "eager" if plain["capture_s"] is None else \
        "its second step replayed"
    print(f"[mesh] (a) {arch}: 2 steps of {batch} x {seq} tokens with "
          f"mesh (1, 1) in {wall:.2f} s (steps "
          + ", ".join(f"{h['seconds']:.3f}" for h in meshed["history"])
          + f" s): losses {meshed['losses']} vs {plain['losses']} without "
          f"({how}), "
          f"largest |diff| {dl:.3g}; params bit-equal {d['share']:.6f}, "
          f"largest difference {d['ulps']:.3g} bf16 ulps, {d['far']} "
          f"elements more than 1 ulp and 2 lr apart", flush=True)
    if dl > CMP_LOSS_ATOL or d["share"] < CMP_PARAM_SHARE or d["far"]:
        raise AssertionError("[mesh] (a) mesh vs plain past [train] (b)'s "
                             "bounds")
    return {"bit_equal": dl == 0 and d["share"] == 1.0}


def mesh_moe(torch, train, dev, mesh, arch=None, smoke=False,
             seq=MOE_TRAIN_SEQ, batch=MOE_TRAIN_BATCH):
    """(b): [train] (d)'s deepseek cut, one step with ``mesh=`` whose MoE
    layers go through ``moe_block_ep`` (counted), its loss against the
    step without (a unit mesh's local capacity is the global one); step
    time and peak memory."""
    from repro_torch.models import layers

    arch = arch or cut_arch(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS)
    kw = dict(arch=arch, steps=1, smoke=smoke, seq_len=seq,
              global_batch=batch, grad_compression=True, seed=0, device=dev,
              log_every=100)
    plain = train(**kw)["losses"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    calls, ep = [], layers.moe_block_ep
    layers.moe_block_ep = lambda *a, **k: calls.append(1) or ep(*a, **k)
    try:
        out = train(mesh=mesh, **kw)
    finally:
        layers.moe_block_ep = ep
    _sync(torch, dev)
    loss = out["losses"][0]
    print(f"[mesh] (b) {arch}: one step of {batch} x {seq} tokens on mesh "
          f"(1, 1): {out['history'][0]['seconds']:.3f} s, peak allocated "
          f"{_peak(torch, dev)} B; moe_block_ep called {len(calls)} times "
          f"(forward and remat's recompute); loss {loss:.6f} vs "
          f"{plain[0]:.6f} without, |diff| {abs(loss - plain[0]):.3g} "
          f"(bound {CMP_LOSS_ATOL})", flush=True)
    if not calls or abs(loss - plain[0]) > CMP_LOSS_ATOL:
        raise AssertionError("[mesh] (b) no EP call, or the loss is off")
    del out


def mesh_pipeline(torch, dev, cfg=None):
    """(c): the pipelined prefill on a (1, 1, 1) (stage, data, model)
    mesh with 2 and 4 microbatches of :data:`MESH_PP_BATCH` x
    :data:`MESH_SEQ` tokens against ``forward``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import make_pp_prefill_step
    from repro_torch.models.model import forward, init_params

    cfg = cfg or dataclasses.replace(ARCHS[MESH_ARCH], n_layers=MESH_LAYERS)
    mesh = make_mesh((1, 1, 1), ("stage", "data", "model"), dev)
    params = init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.ascontiguousarray(_stream(
        cfg, MESH_SEQ, MESH_PP_BATCH).batch_at(0)["tokens"])).to(dev)
    with torch.no_grad():
        want = forward(cfg, params, {"tokens": toks})[0].float()
    line = []
    for n in (2, 4):
        t0 = time.perf_counter()
        got = make_pp_prefill_step(cfg, mesh, n_micro=n)(
            params, {"tokens": toks}).float()
        _sync(torch, dev)
        err = float((got - want).abs().max())
        line.append(f"n_micro {n}: {time.perf_counter() - t0:.3f} s, max "
                    f"|pp - forward| {err:.3g}")
        if got.shape != want.shape or not err <= PP_TOL:
            raise AssertionError(f"[mesh] (c) n_micro {n}: {err}")
    print(f"[mesh] (c) {cfg.name} ({cfg.n_layers} layers), {MESH_PP_BATCH} "
          f"x {MESH_SEQ} tokens, pipelined prefill on (1, 1, 1): "
          + "; ".join(line) + f" (bound {PP_TOL})", flush=True)


def _mesh_rank(rank, store, out):
    """One gloo CPU rank of (d): deepseek-v2-lite-16b at smoke width, one
    train step on a (2, 2) mesh; rank 0 saves the loss and the params."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, MESH_RANKS),
                            rank=rank, world_size=MESH_RANKS)
    try:
        m = make_mesh((2, 2), ("data", "model"), "cpu")
        r = train(arch=MOE_TRAIN_ARCH, steps=1, smoke=True,
                  seq_len=MESH_SMOKE_SEQ, global_batch=MESH_SMOKE_BATCH,
                  seed=0, device="cpu", mesh=m, log_every=100)
        whole = _whole(torch, r["params"])
        if rank == 0:
            torch.save({"losses": r["losses"], "params": whole,
                        "lr": r["history"][0]["lr"]}, out)
    finally:
        dist.destroy_process_group()


def start_gloo_ranks(tmp):
    """(d)'s :data:`MESH_RANKS` gloo CPU ranks, spawned now so that they
    run while the card does [train] and (a)–(c)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store, out = os.path.join(tmp, "gloo_store"), os.path.join(tmp, "r0.pt")
    procs = [ctx.Process(target=_mesh_rank, args=(r, store, out))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    return procs, out, time.perf_counter()


def mesh_gloo_ranks(torch, started):
    """(d): the spawned ranks at (2, 2), one deepseek smoke train step,
    against the single-rank port: the loss within 1e-4 relative, the
    params within [train] (b)'s bounds.  A rank that fails or outlives
    :data:`MESH_RANK_TIMEOUT` from its start fails the phase (and is
    killed)."""
    from repro_torch.launch.train import train

    procs, out, t0 = started
    try:
        deadline = t0 + MESH_RANK_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if any(codes) or not os.path.exists(out):
        raise AssertionError(f"[mesh] (d) ranks exited {codes}")
    got = torch.load(out, weights_only=False)
    one = train(arch=MOE_TRAIN_ARCH, steps=1, smoke=True,
                seq_len=MESH_SMOKE_SEQ, global_batch=MESH_SMOKE_BATCH,
                seed=0, device="cpu", log_every=100)
    d = _state_diff(torch, got["params"], _whole(torch, one["params"]),
                    got["lr"])
    rel = abs(got["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    print(f"[mesh] (d) {MESH_RANKS} gloo CPU ranks at (2, 2), "
          f"{MOE_TRAIN_ARCH} at smoke width, one step of "
          f"{MESH_SMOKE_BATCH} x {MESH_SMOKE_SEQ} tokens, "
          f"{time.perf_counter() - t0:.1f} s from their spawn: loss "
          f"{got['losses'][0]:.6f} vs one rank {one['losses'][0]:.6f} "
          f"(relative {rel:.3g}, bound 1e-4); params bit-equal "
          f"{d['share']:.6f}, {d['far']} elements more than 1 ulp and 2 lr "
          f"apart", flush=True)
    if rel > 1e-4 or d["share"] < CMP_PARAM_SHARE or d["far"]:
        raise AssertionError("[mesh] (d) ranks vs one rank past bounds")


def mesh_path(torch, build, dev="cuda", smoke=False, ranks=None):
    """[mesh]: (d)'s gloo CPU ranks (``ranks``, as :func:`start_gloo_ranks`
    spawned them, else spawned first), then a world of one on ``dev`` and
    its (1, 1) mesh for (a)–(c), then (d) collected; the launch counts set
    to 0 before each part and read after (no kernel of the port is on
    this path); the world of one destroyed after (c)."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train

    dev = torch.device(dev)
    small = dict(smoke=True, seq=MESH_SMOKE_SEQ, batch=2) if smoke else {}
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        ranks = ranks or start_gloo_ranks(tmp)
        _group_of_one(torch, dev, tmp)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), dev)
            parts = (
                ("(a)", lambda: mesh_train_vs_plain(
                    torch, train, dev, mesh,
                    arch=MESH_ARCH if smoke else None, **small)),
                ("(b)", lambda: mesh_moe(
                    torch, train, dev, mesh,
                    arch=MOE_TRAIN_ARCH if smoke else None, **small)),
                ("(c)", lambda: mesh_pipeline(torch, dev, dataclasses.replace(
                    smoke_config(ARCHS[MESH_ARCH]), n_layers=MESH_LAYERS)
                    if smoke else None)))
            for part, fn in parts:
                t0 = time.perf_counter()
                build.reset_launches()
                fn()
                if any(build.LAUNCHES.values()):
                    raise AssertionError(f"[mesh] {part} launched a kernel "
                                         f"of the port: "
                                         f"{dict(build.LAUNCHES)}")
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                print(f"[mesh] {part} done in {time.perf_counter() - t0:.1f}"
                      f" s", flush=True)
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        mesh_gloo_ranks(torch, ranks)
        print(f"[mesh] (d) done in {time.perf_counter() - t0:.1f} s after "
              f"(c)", flush=True)


DRYRUN_ARCH = "qwen2-0.5b"
# (a): meta traces on the card's host, (arch, shape, multi-pod)
DRYRUN_CELLS = tuple((DRYRUN_ARCH, s, mp)
                     for s in ("train_4k", "prefill_32k", "decode_32k")
                     for mp in (False, True)) + (
    ("deepseek-v2-lite-16b", "train_4k", False),
    ("falcon-mamba-7b", "prefill_32k", False))
# (d): train_4k's 16 rows a rank need 123 GB at 24 layers and 120 GB at
# one (the replicated logits and their f32 log-softmax), so no depth
# fits; 7 rows a rank (a global batch of 112) at full depth: 54 GB
DRYRUN_TRAIN_ROWS = 7
PEAK_RTOL = 0.15             # (c), (d): measured peak vs the trace's
DRYRUN_TIMEOUT = 600         # seconds (a)'s process may take, spawn included
DECODE32K_ROWS, DECODE32K_SEQ = 8, 32768     # decode_32k's cell on 16 x 16


def _train_cut():
    from repro_torch.configs import SHAPES

    return dataclasses.replace(SHAPES["train_4k"],
                               global_batch=16 * DRYRUN_TRAIN_ROWS)


def _dryrun_traces(out):
    """(a)'s process: every :data:`DRYRUN_CELLS` cell and (d)'s cut traced
    on meta in fake worlds (the records of qwen2-0.5b's multi-pod
    train_4k cell kept for (b)), saved to ``out``."""
    import torch

    from repro_torch.launch import dryrun

    os.nice(10)             # below the card's phases, which share the host
    torch.set_num_threads(1)
    recs = [dryrun.run_cell(arch, shape, mp, keep_records=(
        arch == DRYRUN_ARCH and shape == "train_4k" and mp))
        for arch, shape, mp in DRYRUN_CELLS]
    recs.append(dryrun.run_cell(DRYRUN_ARCH, _train_cut(), False))
    with open(out, "w") as f:
        json.dump(recs, f)


def start_dryrun_traces(tmp):
    """(a)'s traces, spawned now so that they run while the card does the
    phases before [dryrun]."""
    import multiprocessing as mp

    out = os.path.join(tmp, "dryrun.json")
    proc = mp.get_context("spawn").Process(target=_dryrun_traces,
                                            args=(out,))
    proc.start()
    return proc, out, time.perf_counter()


def _params(cfg) -> int:
    from repro_torch.models.model import abstract_params
    from repro_torch.tree import leaves_with_paths

    return sum(t.numel() for _, t in leaves_with_paths(abstract_params(cfg)))


def dryrun_line(rec) -> str:
    """One cell's line: peak, arguments, FLOPs a rank beside the ideal
    ``k·N·D / chips`` (k 6 for a train step, 2 otherwise; N every
    parameter, experts included), collective bytes, kernel calls."""
    from repro_torch.configs import ARCHS, SHAPES

    cfg = ARCHS[rec["arch"]]
    shape = SHAPES[rec["shape"]]
    tokens = rec["global_batch"] * (1 if shape.is_decode else shape.seq_len)
    k = 6 if shape.kind == "train" else 2
    ideal = k * _params(cfg) * tokens / rec["chips"]
    c = rec["collectives"]
    coll = ", ".join(f"{kind} {c[kind]} B x {c['n_' + kind]}"
                     for kind in ("all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute") if c["n_" + kind])
    ext = rec.get("extrapolated")
    return (f"{rec['arch']} x {rec['shape']} (global batch "
            f"{rec['global_batch']}) x {rec['mesh']}: peak (temp) "
            f"{rec['temp_size_in_bytes']} B, arguments "
            f"{rec['argument_size_in_bytes']} B, FLOPs a rank "
            f"{rec['flops']:.4e} vs {k}·N·D/chips {ideal:.4e} "
            f"({rec['flops'] / ideal:.2f}x), bytes accessed "
            f"{rec['bytes_accessed']:.4e}; collectives {coll}; kernel calls "
            f"{rec['kernel_calls']}; traced in {rec['trace_s']} s"
            + (f"; extrapolated {ext}" if ext else ""))


def multipod_lines(rec) -> tuple:
    """(b): ``verify_multipod``'s analysis and report of qwen2-0.5b's
    multi-pod train_4k records."""
    from repro_torch.launch.verify_multipod import analyse, report

    res = analyse(rec["collective_records"])
    return res, [f"[dryrun] (b) {line}" for line in report(rec["arch"], res)]


def check_real_rank(tag: str, real, meta):
    """(c) / (d): the card's run against the trace: the peak within
    :data:`PEAK_RTOL`, collectives and kernel launches equal."""
    rr = real["real_rank"]
    launches = rr["launches"]
    peak, want = rr["peak_bytes"], meta["temp_size_in_bytes"]
    print(f"[dryrun] {tag} {real['arch']} x {real['shape']} (global batch "
          f"{real['global_batch']}) x {real['mesh']} as rank 0 on the card: "
          f"step {rr['step_s']} s wall, peak {peak} B measured vs {want} B "
          f"predicted ({(peak - want) / want:+.4%}); collectives "
          f"{real['collectives']['total']} B in "
          f"{sum(v for k, v in real['collectives'].items() if k.startswith('n_'))}"
          f" (trace: {meta['collectives']['total']} B); decode_attn "
          f"launches {launches['decode_attn']} (trace: kernel calls "
          f"{meta['kernel_calls']})", flush=True)
    if abs(peak - want) > PEAK_RTOL * want:
        raise AssertionError(f"[dryrun] {tag}: peak {peak} vs {want}")
    if real["collectives"] != meta["collectives"]:
        raise AssertionError(f"[dryrun] {tag}: collectives "
                             f"{real['collectives']} vs {meta['collectives']}")
    if launches["decode_attn"] != meta["kernel_calls"] or any(
            v for k, v in launches.items() if k != "decode_attn"):
        raise AssertionError(f"[dryrun] {tag}: launches {launches} vs "
                             f"{meta['kernel_calls']} kernel calls")


def check_decode32k_attention(torch, k_attn, results):
    """Decode attention at the 16 x 16 decode_32k cell's shape — q (8, 14,
    64) over a full bf16 (8, 32768, 2, 64) cache, 16 work groups — within
    the f32 tolerance of its plain version, bit-equal across two calls;
    timed beside the plain version, the bound and the fastest SDPA
    backend (row ``decode_attn_decode32k``; [dryrun] (c) fills in its
    launches)."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    q = torch.randn((DECODE32K_ROWS, HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((DECODE32K_ROWS, DECODE32K_SEQ, KV_HEADS, HEAD_DIM),
                        generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    valid, scale = DECODE32K_SEQ, HEAD_DIM ** -0.5
    got = k_attn.decode_attention(q, k, v, valid, scale)
    want = k_attn.decode_attention_plain(q, k, v, valid, scale)
    again = k_attn.decode_attention(q, k, v, valid, scale)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= ATOL + RTOL * want.abs()).all()):
        raise AssertionError(f"decode_attn at decode_32k's shape: max error "
                             f"{float(err.max())}")
    if not torch.equal(got, again):
        raise AssertionError("decode_attn at decode_32k's shape differs "
                             "between two calls")
    b, by = bound_ms(DECODE32K_ROWS * (2 * valid * KV_HEADS * HEAD_DIM * 2
                                       + HEADS * HEAD_DIM * 6),
                     DECODE32K_ROWS * 4 * HEADS * valid * HEAD_DIM)
    sdpa_ms = sdpa_backends(torch, q, k, v, valid)
    results["decode_attn_decode32k"] = dict(
        name="decode_attn_decode32k", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:36",
        max_abs_err=float(err.max()), launches=0,
        **timed(torch, lambda: k_attn.decode_attention(q, k, v, valid,
                                                       scale)),
        plain_ms=timed(torch, lambda: k_attn.decode_attention_plain(
            q, k, v, valid, scale), 5)["ms"],
        bound_ms=b, bound_by=by,
        library_ms=min(sdpa_ms.values()) if sdpa_ms else None)
    print("[kernel] SDPA at the decode_32k cell's shape (8 rows, 14 / 2 "
          "heads, hd 64, 32768 positions), by backend: "
          + "; ".join(f"{name} {ms * 1e3:.2f} us"
                      for name, ms in sdpa_ms.items()), flush=True)


def dryrun_path(torch, results, started, dev="cuda"):
    """[dryrun]: (a) the meta traces spawned at the script's start,
    collected, a line a cell; (b) verify_multipod on qwen2-0.5b's
    multi-pod train_4k records; (c) qwen2-0.5b x decode_32k x 16 x 16
    and (d) train_4k cut to :data:`DRYRUN_TRAIN_ROWS` rows a rank, each
    run with real tensors as rank 0 of a fake 256-rank world on ``dev``
    (the launch counts set to 0 before each step and read after),
    against (a)'s traces."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    proc, out, t0 = started
    proc.join(max(0.0, t0 + DRYRUN_TIMEOUT - time.perf_counter()))
    if proc.is_alive():
        proc.kill()
        proc.join(10)
    if proc.exitcode or not os.path.exists(out):
        raise AssertionError(f"[dryrun] (a) traces exited {proc.exitcode}")
    with open(out) as f:
        recs = json.load(f)
    print(f"[dryrun] (a) {len(recs)} cells traced on meta, "
          f"{time.perf_counter() - t0:.1f} s from their spawn", flush=True)
    for rec in recs:
        print(f"[dryrun] (a) {dryrun_line(rec)}", flush=True)
    multi = next(r for r in recs if "collective_records" in r)
    res, lines = multipod_lines(multi)
    for line in lines:
        print(line, flush=True)
    if not res["cross_pod"] or not res["in_pod"]:
        raise AssertionError("[dryrun] (b) no cross-pod or no in-pod "
                             "collectives")
    meta = {(r["shape"], r["mesh"], r["global_batch"]): r for r in recs}
    dev = torch.device(dev)
    for tag, shape in (("(c)", SHAPES["decode_32k"]), ("(d)", _train_cut())):
        want = meta[(shape.name, "16x16", shape.global_batch)]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        real = dryrun.run_cell(DRYRUN_ARCH, shape, False, device=dev)
        check_real_rank(tag, real, want)
        if tag == "(c)":
            n = real["real_rank"]["launches"]["decode_attn"]
            if not n:
                raise AssertionError("[dryrun] (c) launched no decode_attn")
            results["decode_attn_decode32k"]["launches"] = n
            # the host-length entry's path: serving runs the device-length
            # one, so the decode_attn row counts this step's launches
            results["decode_attn"]["launches"] = n


# decode attention with the length on the device (the captured step's
# entry): [main]'s shape, llava-next-34b's and the decode_32k cell's
DEVLEN_SHAPES = (("main", 1, HEADS, KV_HEADS, HEAD_DIM, MAX_SEQ),
                 ("llava", 1, LLAVA_HEADS, LLAVA_KV, LLAVA_HD, LLAVA_SEQ),
                 ("decode_32k", DECODE32K_ROWS, HEADS, KV_HEADS, HEAD_DIM,
                  DECODE32K_SEQ))


def check_devlen_attention(torch, k_attn, results):
    """Decode attention's device-length entry at :data:`DEVLEN_SHAPES`,
    each at valid_len 1, the first position of its grid's second block
    (a tile boundary) and the capacity (and [main]'s 576): within the f32
    tolerance of its plain version on the same tensor length, bit-equal
    across two calls and to a CUDA graph's replay of the call, timed
    beside the host-length entry at the same length.  Row
    ``decode_attn_devlen`` (launches: [main]'s) is [main]'s shape at 576,
    its bound the valid K / V rows read once."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, lines = [], []
    for tag, B, H, KV, hd, S in DEVLEN_SHAPES:
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((B, S, KV, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        chunk = k_attn.split_size(S, B * KV, sms)
        lengths = (1, chunk + 1, S) + ((VALID_LEN,) if tag == "main" else ())
        length = torch.zeros((), dtype=torch.int32, device="cuda")
        # the call captured once, replayed at every length (the counters
        # of a merge through memory made on the capture stream first)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            k_attn.decode_attention(q, k, v, length.fill_(S))
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            replayed = k_attn.decode_attention(q, k, v, length)
        parts = []
        for valid in lengths:
            length.fill_(valid)
            got = k_attn.decode_attention(q, k, v, length)
            want = k_attn.decode_attention_plain(q, k, v, length)
            again = k_attn.decode_attention(q, k, v, length)
            graph.replay()
            torch.cuda.synchronize()
            err = (got - want).abs()
            if not bool((err <= ATOL + RTOL * want.abs()).all()):
                raise AssertionError(
                    f"decode_attn_devlen at {tag}'s shape, valid_len {valid}"
                    f": max error {float(err.max())} beyond atol {ATOL} "
                    f"rtol {RTOL}")
            if not (torch.equal(got, again) and torch.equal(got, replayed)):
                raise AssertionError(
                    f"decode_attn_devlen at {tag}'s shape, valid_len {valid}"
                    f": two calls or a graph replay differ")
            errs.append(float(err.max()))
            dev_t = timed(torch, lambda: k_attn.decode_attention(
                q, k, v, length), 20)
            host_t = timed(torch, lambda: k_attn.decode_attention(
                q, k, v, valid), 20)
            b, _ = bound_ms(B * (2 * valid * KV * hd * 2 + H * hd * 6) + 4,
                            B * 4 * H * valid * hd)
            parts.append(f"valid_len {valid}: device length {us(dev_t)}, "
                         f"host length {us(host_t)}, bound {b * 1e3:.3f} us")
            if tag == "main" and valid == VALID_LEN:
                row_t, row_b = dev_t, b
        del graph
        lines.append(f"[kernel] decode_attn_devlen at {tag}'s shape, q "
                     f"{(B, H, hd)} over {(B, S, KV, hd)} ({-(-S // chunk)} "
                     f"blocks a (row, KV head), every position): "
                     + "; ".join(parts))
    for line in lines:
        print(line, flush=True)
    q = torch.randn((1, HEADS, HEAD_DIM), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((1, MAX_SEQ, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    length = torch.tensor(VALID_LEN, dtype=torch.int32, device="cuda")
    results["decode_attn_devlen"] = dict(
        name="decode_attn_devlen", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:36",
        max_abs_err=max(errs), **row_t,
        plain_ms=timed(torch, lambda: k_attn.decode_attention_plain(
            q, k, v, length))["ms"],
        bound_ms=row_b, bound_by="bytes",
        library_ms=results["decode_attn"]["library_ms"])


# [graph]: one full-width qwen2-0.5b request of 512 + 64 tokens through a
# ServeEngine whose decode step is one CUDA graph, as [main] serves
GRAPH_SEED = 26
# PR 25's eager decode step, one such request under torch.profiler
# ([profile], chiprun_out/final2.log of that PR; NVIDIA H100 80GB HBM3 at
# 700.00 W): printed beside [graph] (c), not measured here
PR25_EAGER = dict(wall_s=3.996, busy=0.061, events=248254)


def host_int_engine(ServeEngine, decode_step):
    """A ServeEngine whose decode step runs eagerly at a host int position
    — the port's serving path through PR 25, reachable through
    ``decode_step`` with an int — for [graph] (b)'s comparison."""
    class HostIntEngine(ServeEngine):
        def _decode_logits(self, tokens):
            return decode_step(self.cfg, self.params, {
                "tokens": tokens, "cache_pos": self.pos}, self.cache)[0]
    return HostIntEngine


def graph_path(torch, build, serve, cfg, params, dev="cuda",
               prompt_len=512, n_tokens=64, engine_kw=SCHED_ENGINE):
    """[graph]: (a) one request's decode steps through the captured step,
    each replay's logits bit-equal to ``decode_step`` run eagerly at the
    same tensor position on a copy of the cache at the same state (the
    readback written into the cache between replays included: each
    replay attends to it); (b) the same tokens teacher-forced through the
    eager step at host int positions (PR 25's path): logits within the
    margin-aware bound; (c) a request through ``serve``: wall tok/s, and
    under torch.profiler the device's busy share and kernels, beside PR
    25's eager figures, with the capture's host seconds.  Launches of the
    comparisons are not counted.  Returns (a)'s launches."""
    import numpy as np

    from repro_torch.models.model import decode_step
    from repro_torch.runtime import PAPER_POLICY, ServeEngine

    dev = torch.device(dev)
    max_seq = prompt_len + n_tokens + engine_kw["page_tokens"]
    prompt = np.random.default_rng(GRAPH_SEED).integers(
        0, cfg.vocab, (1, prompt_len)).astype(np.int32)

    def engine(cls):
        return cls(cfg, params, max_seq=max_seq, batch=1,
                   device_kind="trace", policy=PAPER_POLICY, device=dev,
                   **engine_kw)

    # (a) replay == eager at the same tensor position and cache
    eng = engine(ServeEngine)
    written = dict(pages=0, words=0)
    apply = eng._apply_readback

    def recording(pages, data):
        layers, page = eng.cache["layers"], eng.page_tokens
        win = [layers[p.kind][p.layer, :, p.start:p.start + page]
               for p in pages]
        before = [w.clone() for w in win]
        apply(pages, data)
        written["pages"] += len(pages)
        written["words"] += sum(int((a.view(torch.int16) != b.view(
            torch.int16)).sum()) for a, b in zip(win, before))

    eng._apply_readback = recording
    t0 = time.perf_counter()
    build.reset_launches()
    logits = eng.prefill(prompt)
    tokens, rows = [], []
    for step in range(n_tokens):
        nxt = np.array([[int(np.argmax(logits[0]))]], dtype=np.int32)
        tokens.append(int(nxt[0, 0]))
        counted = dict(build.LAUNCHES)
        copy = _map_leaves(eng.cache, lambda t: t.clone())
        want, _ = decode_step(cfg, params, {
            "tokens": torch.from_numpy(nxt.astype(np.int64)).to(dev),
            "cache_pos": torch.tensor(eng.pos, dtype=torch.int32,
                                      device=dev)}, copy)
        want = want[:, -1].float().cpu().numpy()
        del copy
        build.LAUNCHES.update(counted)
        logits = eng.decode(nxt)
        if not np.array_equal(want, logits):
            raise AssertionError(
                f"[graph] (a) step {step}: the replay differs from the eager "
                f"step by {float(np.abs(want - logits).max())}")
        rows.append(logits[0])
    _sync(torch, dev)
    launches = dict(build.LAUNCHES)
    check_serving_launches("[graph] (a)", launches)
    g = eng.graph
    if written["words"] == 0:
        raise AssertionError("[graph] (a) no readback changed the cache "
                             "between replays")
    if dev.type == "cuda" and g is None:
        raise AssertionError("[graph] (a) the engine captured no graph")
    captured = ("no capture on the CPU" if g is None else
                f"capture {g.capture_s:.3f} s, warm-up {g.warmup_s:.3f} s "
                f"(host); a replay launches {g.launches}")
    print(f"[graph] (a) {n_tokens} decode steps replayed, every one "
          f"bit-equal to decode_step run eagerly at the same tensor position"
          f" on a copy of the cache; between replays {written['pages']} "
          f"pages read back into the cache changed {written['words']} "
          f"words, which the next replays attended to; {captured}; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng.retire()

    # (b) the same tokens through the eager step at host int positions
    t0 = time.perf_counter()
    counted = dict(build.LAUNCHES)
    ref = engine(host_int_engine(ServeEngine, decode_step))
    ref.prefill(prompt)
    ref_rows = [ref.decode(np.array([[t]], dtype=np.int32))[0]
                for t in tokens]
    ref.retire()
    build.LAUNCHES.update(counted)
    ref_rows, rows = np.stack(ref_rows), np.stack(rows)
    bound = margin_bound(np, ref_rows, rows, "[graph] (b)")
    print(f"[graph] (b) the graph's logits against the eager step at host "
          f"int positions (PR 25's path), teacher-forced on (a)'s tokens: "
          f"{bound}; last logits max |diff| "
          f"{float(np.abs(ref_rows[-1] - rows[-1]).max()):.4g}, greedy "
          f"token equal {ref_rows[-1].argmax() == rows[-1].argmax()}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c) wall and device busy share of a request through the graph
    if dev.type != "cuda":
        return launches
    t0 = time.perf_counter()
    rep = serve(**_request_kw(params, seed=GRAPH_SEED))
    prof = device_profile(torch, serve, params, seed=GRAPH_SEED)
    busy = prof["busy_s"] / prof["wall_s"]
    print(f"[graph] (c) one request of {prompt_len} + {n_tokens} tokens: "
          f"wall {rep.wall_s:.3f} s, {rep.tok_s:.3f} tok/s; under "
          f"torch.profiler wall {prof['wall_s']:.3f} s, device busy "
          f"{prof['busy_s']:.3f} s ({100 * busy:.1f}%), "
          f"{prof['device_events']} kernels and copies on the card "
          f"({prof['events']} events with the runtime calls, as PR 25 "
          f"counted), decode attention {prof['attn_s'] * 1e3:.1f} ms; PR "
          f"25's eager step (its [profile] on its card, not measured here): "
          f"wall {PR25_EAGER['wall_s']:.3f} s, busy "
          f"{100 * PR25_EAGER['busy']:.1f}%, {PR25_EAGER['events']} events;"
          f" top: " + "; ".join(f"{k[:60]} {t / 1e3:.1f} ms x{n}"
                                for k, t, n in prof["top"])
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# the kernels only the kernel API reaches
API_ONLY_KERNELS = ("elastic_matmul", "kv_delta_inv")
# rows of the kernels line for [mla]'s 512-channel shapes
LATENT_ROWS = ("kv_delta_fwd_latent", "bitplane_unpack_latent",
               "pnm_score_latent")


def np_equal(x, y) -> bool:
    return x.shape == y.shape and bool((x == y).all())


def _to(tree, dev):
    return _map_leaves(tree, lambda t: t.to(dev))


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
    # cuBLAS reads this at its first call: [train] (c) runs under
    # torch.use_deterministic_algorithms(True), which needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # one nvcc per source, all started now; the kernel checks run while
    # they compile, each waiting for its own library, in the order the
    # builds finish (elastic_matmul.cu, with 32 instantiations, last)
    build.start_all()

    last = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        print(f"[time] {name} done at {now - t0:.1f} s (the phase "
              f"{now - last[0]:.1f} s)", flush=True)
        last[0] = now

    dryrun_tmp = tempfile.mkdtemp(prefix="dryrun_")
    dryrun_traces = start_dryrun_traces(dryrun_tmp)
    results = {}
    check_pnm_score(torch, k_pnm, results)
    check_kv_and_unpack(torch, build, k_bitplane, k_kv, results)
    check_lz4_match(torch, k_bitplane, k_kv, k_lz4, results)
    check_latent_kernels(torch, build, k_bitplane, k_kv, k_pnm, results)
    check_kernels(torch, k_bitplane, k_lz4, k_attn, results)
    check_llava_attention(torch, k_attn, results)
    check_decode32k_attention(torch, k_attn, results)
    check_devlen_attention(torch, k_attn, results)
    check_elastic_matmul(torch, k_bitplane, k_mm, ops, results)
    libs = build.build_all()
    print(f"[build] {len(libs)} kernels built, the last by "
          f"{time.perf_counter() - t0:.1f} s, beside the checks above",
          flush=True)
    for r in results.values():
        lib = r["library_ms"]
        lib = "-" if lib is None else f"{lib * 1e3:.2f} us"
        print(f"[kernel] {r['name']}: {r['ms'] * 1e3:.2f} us {ms_label(r)} "
              f"({r['call_ms'] * 1e3:.2f} us per call "
              f"back to back), plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}, library "
              f"{lib}; max abs err {r['max_abs_err']:.3g}", flush=True)
    phase("kernel checks")
    api_launches = kernel_api_path(torch, build, ops, k_mm)
    for name in API_ONLY_KERNELS:
        results[name]["launches"] = api_launches[name]
    phase("kernel API")
    diffs = check_tier_and_model(torch)
    print(f"[check] tier encode, readback at every view and PNM gathers "
          f"cuda == cpu; the per-block encoder == the batched one on the "
          f"card; smoke-model logits cuda vs cpu max |diff| "
          + ", ".join(f"{k} {v:.4g}" for k, v in diffs.items()), flush=True)
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
    graph_path(torch, build, serve, ARCHS["qwen2-0.5b"], params)
    phase("graph")
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
    sched_path(torch, build, *cut_depth(cfg, params, SCHED_LAYERS), dev,
               engine_kw=SCHED_CUT_ENGINE)
    phase("scheduler path")
    streams_path(torch, build, *cut_depth(cfg, params, SCHED_LAYERS), dev,
                 engine_kw=SCHED_CUT_ENGINE)
    phase("multi-stream path")
    examples_path(torch, build)
    phase("examples")
    mla_path(torch, build, k_bitplane, k_kv, k_pnm, serve, results)
    phase("MLA path")
    ssm_path(torch, build, k_bitplane, serve)
    phase("SSM path")
    frontends_path(torch, build, results)
    phase("frontends")
    mesh_tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    gloo_ranks = start_gloo_ranks(mesh_tmp)     # [mesh] (d), beside [train]
    train_path(torch, build)
    phase("train")
    mesh_path(torch, build, ranks=gloo_ranks)
    shutil.rmtree(mesh_tmp, ignore_errors=True)
    phase("mesh")
    dryrun_path(torch, results, dryrun_traces)
    shutil.rmtree(dryrun_tmp, ignore_errors=True)
    phase("dryrun")
    profile_request(torch, serve, params)
    profile_request(torch, serve, params, pnm_topk=16,
                    importance="attention")
    phase("profile")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys}
                                  for n in build.KERNELS
                                  + ("bitplane_unpack_planes",)
                                  + LATENT_ROWS + ("decode_attn_llava",
                                                   "decode_attn_decode32k")]}),
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
