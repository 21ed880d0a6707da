"""Design alternatives of the port's decode attention, elastic matmul,
fused KV read, LZ4 match, page scoring and KV forward, timed on one
NVIDIA GPU beside the shipped choice.

Run from the repository root on a machine with a card:

    python3 chip_variants.py [--only score,forward,...] [--parent CSRC]

``--only`` runs the named sweeps (attention, matmul, kv_read, inverse,
match, score, forward, pack, prep; default all); ``--parent`` names
another checkout's ``src/repro_torch/csrc``, whose ``pnm_score.cu``,
``kv_delta.cu``, ``bitplane_pack.cu`` and ``lz4_prep.cu`` then join the
scoring, forward, pack and prep sweeps as ``parent``.

- Decode attention, q (1, 14, 64) over a (1, S, 2, 64) bf16 cache: at
  each valid length, every block size (``chunk``) of 2 to 64 blocks a
  row, launched through the library with that chunk — up to 16 blocks a
  row merge in a thread block cluster, more through device memory — and
  the one ``kernels.decode_attn.split_size`` picks, marked (and added
  where it is not among them).  Also the device time of the
  counter fill an earlier wrapper launched per call.
- Elastic matmul at M = 1 on the (896, 4864) MLP up-projection: the
  shipped kernels against variants built from the same source by text
  substitution (``MATMUL_VARIANTS``): the tensor-core kernel at M = 1
  too, and the guard round as a runtime branch; in the order shipped,
  each variant twice, shipped.
- Fused KV read (unpack -> exponent-delta inverse -> round) of a decode
  slab's 8 windows x 64 tokens x 128 channels at FULL, MAN4 and SCORE
  (16, 14, 9 planes): the shipped kernel against variants of
  ``bitplane_unpack.cu`` (``KV_READ_VARIANTS``): other channel tiles
  and tokens a thread (``t<channels>k<tokens>``), and the plane loop
  rolled, as a runtime plane
  count would leave it (each load used before the next is issued), and
  the standalone unpack's block of 64 or 256 threads instead of 128
  (``u<threads>``); the standalone unpack of the same rows under each;
  and the
  standalone inverse with the same tiles and tokens a thread
  (``INVERSE_VARIANTS``).
- LZ4 match at the main path's flush shape (256 streams of 1024 bytes,
  the pre-screen's gaps; the smoke's synthetic slab and the first slab a
  served request spills): the shipped ``lz4_match.cu`` against variants
  (``MATCH_VARIANTS``): prev() by a bitonic sort in shared memory instead
  of the position-ordered table, the same-hash lanes by a ballot per hash
  bit instead of ``__match_any_sync``, the hash-table pass in 1, 2 or 8
  segments (shipped: 4), a warp or 2-8 warps per stream (shipped: 16),
  1-8 streams per block, and the lanes' length and mask-scan reach; then
  the shipped kernel's clocks per phase (``PHASE_CLOCKS``).
- Page scoring at the served gather (64 pages x 64 rows x 128
  channels) and at a long-context one (2048 pages): the shipped
  ``pnm_score.cu`` against variants (``SCORE_VARIANTS``): a cluster of 2
  or 4 blocks a page (``pages_by_cluster``; shipped: a block a page), 3
  or 4 stages (shipped 2), 8 or 16
  values a lane in flight (rows summed at once; shipped 32), 2 or 3
  blocks an SM in the persistent grid (shipped 4), 8 KiB stages
  (shipped 16), 512 threads a block (shipped 256).
- KV forward at the served flush (128 windows x 64 x 128) and at 2048
  windows: the shipped ``kv_delta.cu`` forward against variants
  (``FORWARD_VARIANTS``): 64 channels a block, 4 or 16 token groups
  (shipped 32 channels, 8 groups), registers capped for 1 or 6 resident
  blocks an SM
  (``__launch_bounds__``; shipped 4), and the mode found by a warp per
  channel walking its
  distinct exponents in increasing order (``MODE_BY_WARP``) instead of
  the counted bins.
- Bit-plane pack at the flush slab (131072 elements) and at a 896 x 4864
  weight: the shipped ``bitplane_pack.cu`` against variants
  (``PACK_VARIANTS``): 64-256 threads a block (shipped 32), 2 or 8 runs
  of 8 elements a thread (shipped 4), and the planes by a warp ballot
  per plane over 32 consecutive elements (``PACK_BY_BALLOT``) instead of
  the register transpose; back to back and from a cold L2, after the
  floor of one launch.
- LZ4 prep over those slabs' planes, with and without run flags: the
  shipped ``lz4_prep.cu`` against variants (``PREP_VARIANTS``): 8 or 16
  positions a lane (shipped 4) and 128 or 512 threads a block (shipped
  256); back to back and from a cold L2.

Every call is held to its plain version (the tolerances of
``chip_smoke.py``); times are device time per call from
``torch.profiler``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import chip_smoke as cs

sys.path.insert(0, str(cs.ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import precision  # noqa: E402
from repro_torch.kernels import bitplane as k_bitplane  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as k_attn  # noqa: E402
from repro_torch.kernels import elastic_matmul as k_mm  # noqa: E402
from repro_torch.kernels import kv_delta as k_kv  # noqa: E402
from repro_torch.kernels import lz4 as k_lz4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

VALID_LENS = (576, 1024, 1536, 2048, 3072, 4096, 4097, 8192, 16384,
              32768)
CHUNKS = (32, 64, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024)
KERNEL_SPLITS = 64           # blocks a row the kernel takes (kMaxSplits)


def in_turns(variants: dict) -> list:
    """Shipped, each variant twice, shipped."""
    return ["shipped"] + [v for v in variants for _ in (0, 1)] + ["shipped"]


def attention_sweep() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    fn = build.load("decode_attn").decode_attn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, KV, hd = 1, cs.HEADS, cs.KV_HEADS, cs.HEAD_DIM
    counters = torch.zeros(B * KV, dtype=torch.int32, device="cuda")
    for valid in VALID_LENS:
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((B, valid, KV, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        want = k_attn.decode_attention_plain(q, k, v, valid, 1.0)
        chosen = k_attn.split_size(valid, B * KV, sms)
        parts = []
        for chunk in sorted(set(CHUNKS) | {chosen}):
            n = -(-valid // chunk)
            if not 2 <= n <= KERNEL_SPLITS:
                continue
            out = torch.empty((B, H, hd), dtype=torch.float32, device="cuda")
            scratch = torch.empty(B * H * n * (hd + 2), dtype=torch.float32,
                                  device="cuda")

            def call():
                build.check(fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), counters.data_ptr(), B, H, KV, valid,
                    hd, valid, chunk, 1.0, 0, 0,
                    torch.cuda.current_stream().cuda_stream), "decode_attn")

            call()
            torch.cuda.synchronize()
            if not bool(((out - want).abs()
                         <= cs.ATOL + cs.RTOL * want.abs()).all()):
                raise AssertionError(f"decode_attn valid {valid} chunk "
                                     f"{chunk} beyond tolerance")
            t = cs.timed(torch, call)["ms"]
            parts.append(f"{chunk}x{n} {'cluster' if n <= 16 else 'memory'}"
                         f" {t * 1e3:.2f}{' *' if chunk == chosen else ''}")
        print(f"[variant] decode_attn valid_len {valid} (chunk x blocks a "
              "row, merge, us; * the split_size choice): "
              + "; ".join(parts), flush=True)
    fill = cs.timed(torch, lambda: torch.zeros(B * KV, dtype=torch.int32,
                                               device="cuda"))["ms"]
    print(f"[variant] a {B * KV}-counter torch.zeros fill: {fill * 1e3:.2f} "
          "us device", flush=True)


# Variants of elastic_matmul.cu, each as text substitutions of the source.
MATMUL_VARIANTS = {
    # the tensor-core kernel at M = 1 too: the M = 1 branch removed
    "mma": (("  if (a.M == 1)\n", "  if (false)\n"),),
    # the guard round as a runtime branch of one instantiation per P (cut
    # 0 meaning no round) instead of a template parameter
    "runtime-round": (
        ("  if (ROUND)\n    return view_round(",
         "  if (ROUND && cut != 0)\n    return view_round("),
        ("return do_round ? launch<P, true>(a) : launch<P, false>(a);",
         "return launch<P, true>(a);"),
        ("static_cast<uint32_t>(keep), cut, vec,",
         "static_cast<uint32_t>(keep), do_round ? cut : 0, vec,")),
}


def tile_variant(source: str, tc: int, k: int) -> tuple:
    """Substitutions giving ``csrc/<source>.cu`` a tile of ``tc`` channels
    and ``k`` tokens a thread in place of its shipped ones."""
    text = (build.CSRC / f"{source}.cu").read_text()
    subs = []
    for const, val in (("kTileChannels", tc), ("kTokensPerThread", k)):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr int {const} = "))
        subs.append((line, f"constexpr int {const} = {val};"))
    return tuple(subs)


# Variants of bitplane_unpack.cu: the fused KV read's channel tile and
# tokens a thread, and the plane loop rolled (one load in flight at a
# time); of kv_delta.cu: the standalone inverse's tile and tokens.
KV_READ_VARIANTS = {
    f"t{tc}k{k}": tile_variant("bitplane_unpack", tc, k)
    for tc, k in ((4, 1), (4, 2), (4, 4), (8, 1), (8, 4), (16, 2), (16, 4),
                  (32, 4), (32, 8))
}
KV_READ_VARIANTS.update({
    f"u{nt}": (("constexpr int kUnpackThreads = 128;",
                f"constexpr int kUnpackThreads = {nt};"),)
    for nt in (64, 256)
})
INVERSE_VARIANTS = {
    f"t{tc}k{k}": tile_variant("kv_delta", tc, k)
    for tc, k in ((4, 1), (4, 2), (8, 2), (16, 1), (16, 4), (32, 8))
}
KV_READ_VARIANTS["rolled"] = (
    ("#pragma unroll  // every plane's load in flight at once",
     "#pragma unroll 1"),)


def const_variant(source: str, **values) -> tuple:
    """Substitutions giving ``csrc/<source>.cu`` other values of its
    ``constexpr`` design constants."""
    text = (build.CSRC / f"{source}.cu").read_text()
    subs = []
    for const, val in values.items():
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr ")
                    and f" {const} = " in ln)
        head = line.split(" = ")[0]
        subs.append((line, f"{head} = {val};"))
    return tuple(subs)


# lz4_match.cu with prev() by a bitonic sort of (hash << 16 | position)
# keys in shared memory (the reference's algorithm, per stream): the
# sorted neighbour of the same hash.  Streams past the tile keep the
# tables (their positions do not fit 16 bits).
PREV_BY_SORT = (
    ("__host__ __device__ constexpr int prev_bytes(int) {\n"
     "  return kSegments * 2 * kTableEntries;\n}\n",
     "__host__ __device__ constexpr int pow2_at_least(int n) {\n"
     "  int p = 1;\n  while (p < n) p <<= 1;\n  return p;\n}\n"
     "__host__ __device__ constexpr int prev_bytes(int tile) {\n"
     "  return 4 * pow2_at_least(tile);\n}\n"),
    ("// Phase 2: the candidate test", """\
template <typename H, typename I>
__device__ void sort_pass(const Stream<H, I>& st, uint32_t* keys, int team,
                          int tid) {
  const int n = pow2_at_least(st.nval);
  for (int i = tid; i < n; i += kTeam)
    keys[i] = i < st.nval ? (static_cast<uint32_t>(st.H[i]) << 16) | i
                          : 0xFFFFFFFFu;
  team_sync(team);
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n; i += kTeam) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint32_t a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      team_sync(team);
    }
  }
  for (int i = tid; i < st.nval; i += kTeam) {
    const uint32_t key = keys[i];
    const bool same = i > 0 && (keys[i - 1] >> 16) == (key >> 16);
    st.dist[key & 0xFFFFu] =
        same ? static_cast<I>((keys[i - 1] & 0xFFFFu) + 1u) : static_cast<I>(0);
  }
}

// Phase 2: the candidate test"""),
    ("  const int segw = (st.nwords + kSegments - 1) / kSegments;\n"
     "  for (int g = tid / 32; g < kSegments; g += kWarpsPerStream)\n",
     "  if constexpr (sizeof(I) == 2) {\n"
     "    sort_pass(st, reinterpret_cast<uint32_t*>(st.table), team, tid);\n"
     "  } else {\n"
     "  const int segw = (st.nwords + kSegments - 1) / kSegments;\n"
     "  for (int g = tid / 32; g < kSegments; g += kWarpsPerStream)\n"),
    ("  if (kSegments > 1) link_segments(st, segw, tid);\n",
     "  if (kSegments > 1) link_segments(st, segw, tid);\n  }\n"),
    ("    int4* t4 = reinterpret_cast<int4*>(base);\n"
     "    for (int i = tid; i < prev_bytes(tile) / 16; i += kTeam)\n"
     "      t4[i] = make_int4(0, 0, 0, 0);\n", ""),
)
# lz4_match.cu with the same-hash lanes of a step found by one ballot per
# hash bit instead of __match_any_sync.
PEERS_BY_BALLOT = (
    ("    const unsigned peers = __match_any_sync(kFull, hq);\n",
     "    unsigned peers = kFull;\n"
     "#pragma unroll\n"
     "    for (int b = 0; b <= kHashLog; ++b) {\n"
     "      const unsigned v = __ballot_sync(kFull, (hq >> b) & 1u);\n"
     "      peers &= (hq >> b) & 1u ? v : ~v;\n"
     "    }\n"),
)

# Variants of lz4_match.cu (shipped: the tables of 4 segments,
# __match_any_sync, 16 warps a stream, one stream a block).
MATCH_VARIANTS = {
    "sort": PREV_BY_SORT,
    "ballot": PEERS_BY_BALLOT,
    "ballot-w8": PEERS_BY_BALLOT + const_variant("lz4_match",
                                                 kWarpsPerStream=8),
    **{f"w{w}s{n}": const_variant("lz4_match", kWarpsPerStream=w,
                                  kStreamsPerBlock=n)
       for w, n in ((1, 1), (1, 4), (1, 8), (2, 2), (4, 1), (4, 2),
                    (4, 4), (8, 1))},
    **{f"seg{n}": const_variant("lz4_match", kSegments=n)
       for n in (1, 2, 8)},
    "lcp4": const_variant("lz4_match", kLcpWords=4),
    "lcp16": const_variant("lz4_match", kLcpWords=16),
    "scan1": const_variant("lz4_match", kScanWords=1),
    "scan4": const_variant("lz4_match", kScanWords=4),
}


def variant_libs(source: str, variants: dict, csrc=build.CSRC) -> dict:
    """Build every variant of ``<csrc>/<source>.cu``, one nvcc each,
    together: {variant: library, its C launchers' signatures set}."""
    src = (csrc / f"{source}.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"{source}.cu: {old!r} moved")
            text = text.replace(old, new)
        cu = out / f"{source}_{name}.cu"
        cu.write_text(text)
        so = out / f"lib{source}_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(so), str(cu)]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {source} {name} variant")
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in build.SIGNATURES[source].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def matmul_m1(variants: dict) -> None:
    import numpy as np

    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.standard_normal((cs.D_MODEL, cs.D_FF)) * 0.02)
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    planes = k_mm.pack_weights_kmajor(w)
    x = torch.from_numpy(rng.standard_normal((1, cs.D_MODEL)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    shipped = build.load("elastic_matmul").elastic_matmul
    K, N = cs.D_MODEL, cs.D_FF
    for r_m, d_m in ((7, 0), (0, 0), (6, 1)):
        ids = ops.fetch_planes(8, r_m, d_m)
        fetched = planes[ids].contiguous()
        keep, cut, rnd = k_bitplane.round_params(8, r_m, d_m)
        want = k_mm.elastic_matmul_plain(x, fetched, ids, (keep, cut, rnd))
        times = []
        order = [("shipped", shipped)]
        for name, lib in variants.items():
            order += [(name, lib.elastic_matmul), (name, lib.elastic_matmul)]
        for name, fn in order + [("shipped", shipped)]:
            out = torch.empty((1, N), dtype=torch.float32, device="cuda")

            def call(fn=fn, out=out):
                build.check(fn(x.data_ptr(), fetched.data_ptr(), K // 8 * N,
                               out.data_ptr(), 1, K, N, len(ids), keep, cut,
                               int(rnd), 0,
                               torch.cuda.current_stream().cuda_stream),
                            "elastic_matmul")

            call()
            torch.cuda.synchronize()
            if not bool(((out - want).abs()
                         <= cs.MM_ATOL + cs.MM_RTOL * want.abs()).all()):
                raise AssertionError(f"elastic_matmul {name} r_m {r_m} d_m "
                                     f"{d_m} beyond tolerance")
            times.append(f"{name} {cs.timed(torch, call)['ms'] * 1e3:.2f}")
        print(f"[variant] elastic_matmul M=1 r_m {r_m} d_m {d_m} "
              f"({len(ids)} planes), us: " + ", ".join(times), flush=True)


def kv_read(variants: dict) -> None:
    """The fused KV read and the standalone unpack of the same rows at a
    decode slab's shape, shipped and variants, each call held bit-equal
    to the plain version."""
    nwin, n, C = 8, cs.WINDOW, cs.CHANNELS
    x = cs.kv_windows(torch, nwin, n, 12)
    cm, beta = k_kv.kv_forward(x)
    planes = k_bitplane.pack_planes_u16(cm.reshape(-1))
    nbytes = planes.shape[1]
    starts = torch.arange(nwin, dtype=torch.int64) * n * C
    libs = dict(shipped=build.load("bitplane_unpack"), **variants)
    for view in (precision.FULL, precision.MAN4, precision.SCORE):
        ids = view.fetched_planes()
        rows = planes[list(ids)].contiguous()
        code = k_bitplane.plane_code(ids)
        keep, cut, rnd = k_bitplane.view_round_params(view)
        want = k_bitplane.unpack_kv_windows_plain(
            rows, ids, starts.tolist(), n, C, beta, view)
        flat_want = k_bitplane.unpack_planes_plain(rows, ids)
        times, unpack_times = [], []
        order = in_turns(variants)
        for name in order:
            lib = libs[name]
            out = torch.empty((nwin, n, C), dtype=torch.int16, device="cuda")
            flat = torch.empty(8 * nbytes, dtype=torch.int16, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def fused(lib=lib, out=out):
                build.check(lib.unpack_kv_windows(
                    rows.data_ptr(), nbytes, len(ids), code,
                    starts.data_ptr(), beta.data_ptr(), out.data_ptr(), nwin,
                    n, C, keep, cut, int(rnd), 0, stream), "bitplane_unpack")

            def alone(lib=lib, flat=flat):
                build.check(lib.unpack_planes_u16(
                    rows.data_ptr(), flat.data_ptr(), nbytes, len(ids), code,
                    0xFFFF, 1, 0, 0, stream), "bitplane_unpack")

            fused()
            alone()
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(flat, flat_want)):
                raise AssertionError(f"kv read {name} ({view.name}) differs "
                                     "from its plain version")
            times.append(f"{name} {cs.timed(torch, fused)['ms'] * 1e3:.2f}")
            unpack_times.append(
                f"{name} {cs.timed(torch, alone)['ms'] * 1e3:.2f}")
        print(f"[variant] kv read fused {nwin} x {n} x {C} {view.name} "
              f"({len(ids)} planes), us: " + ", ".join(times) + "; the "
              "standalone unpack, us: " + ", ".join(unpack_times),
              flush=True)


def inverse(variants: dict) -> None:
    """The standalone inverse + MAN4 round of a decode slab's 8 windows,
    shipped and with other channel tiles, held to the plain version."""
    nwin, n, C = 8, cs.WINDOW, cs.CHANNELS
    cm, beta = k_kv.kv_forward(cs.kv_windows(torch, nwin, n, 13))
    keep, cut, rnd = k_bitplane.view_round_params(precision.MAN4)
    want = k_kv.kv_inverse_plain(cm, beta, precision.MAN4)
    libs = dict(shipped=build.load("kv_delta"), **variants)
    times = []
    for name in in_turns(variants):
        lib = libs[name]
        out = torch.empty((nwin, n, C), dtype=torch.int16, device="cuda")

        def call(lib=lib, out=out):
            build.check(lib.kv_delta_inv(
                cm.data_ptr(), beta.data_ptr(), out.data_ptr(), nwin, n, C,
                keep, cut, int(rnd), 0,
                torch.cuda.current_stream().cuda_stream), "kv_delta_inv")

        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"kv_delta_inv {name} differs")
        times.append(f"{name} {cs.timed(torch, call)['ms'] * 1e3:.2f}")
    print(f"[variant] kv_delta_inv {nwin} x {n} x {C} man4, us: "
          + ", ".join(times), flush=True)


def served_flush_slab():
    """The first encode slab a full-width qwen2-0.5b request (random
    weights, seed 0) hands the match kernel: its prefill spill."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params

    seen = []
    wrapped = k_lz4.lz4_match

    def record(buf, starts, ends):
        if not seen:
            seen.append((buf.clone(), starts.copy(), ends.copy()))
        return wrapped(buf, starts, ends)

    k_lz4.lz4_match = record
    try:
        serve(arch="qwen2-0.5b", device="trace", prompt_len=512, n_tokens=2,
              batch=1, requests=1, hbm_kv_budget=1 << 22, page_tokens=64,
              seed=0, torch_device="cuda", verbose=False,
              params=init_params(ARCHS["qwen2-0.5b"], seed=0, device="cuda"))
    finally:
        k_lz4.lz4_match = wrapped
    return seen[0]


# The shipped lz4_match.cu with clock64() reads at each phase boundary,
# per stream, read back through lz4_match_phases.
PHASE_CLOCKS = (
    ("namespace {\n", "namespace {\n__device__ long long g_phase[8 * 4096];\n"
     "__device__ long long g_start[4096];\n"),
    ("  if (s >= S) return;\n",
     "  if (s >= S) return;\n  if (tid == 0) g_start[s] = clock64();\n"),
    ("  __shared__ int events[kStreamsPerBlock];\n",
     "  __shared__ int events[kStreamsPerBlock];\n  long long clk[7];\n"
     "  clk[0] = clock64();\n"),
    *((f"  team_sync(team);\n  {nxt}", f"  team_sync(team);\n  clk[{i}] = "
       f"clock64();\n  {nxt}")
      for i, nxt in ((1, "mask_pass"), (2, "length_pass"), (3, "jump_pass"),
                     (4, "if (tid < 32) {"), (5, "const int n = events"))),
    ("  emit(st, n, start, pos, dst, len, tid);\n  return n;",
     "  emit(st, n, start, pos, dst, len, tid);\n  if (tid == 0) {\n"
     "    const int sidx = blockIdx.x * (blockDim.x / kTeam) + team;\n"
     "    long long* d = g_phase + 8 * sidx;\n"
     "    d[0] = clk[0] - g_start[sidx];\n"
     "    for (int i = 1; i < 6; ++i) d[i] = clk[i] - clk[i - 1];\n"
     "    d[6] = clock64() - clk[5];\n    d[7] = n;\n  }\n  return n;"),
    ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int "
     "lz4_match_phases(void* dst, int n) {\n  return static_cast<int>("
     "cudaMemcpyFromSymbol(dst, g_phase, 8 * sizeof(long long) * n));\n}\n"),
)
PHASES = ("stage", "prev", "masks", "lengths", "jumps", "walk", "emit")


def match_sweep(variants: dict) -> None:
    """The LZ4 match launch at two flush slabs (the smoke's synthetic KV
    windows, and the first slab a served request spills), shipped and
    variants, each variant's events held equal to the numpy twin's; then
    the shipped kernel's phases per stream."""
    slabs = {"smoke flush slab": cs.flush_slab(torch, k_bitplane, k_kv, 3),
             "served flush slab": served_flush_slab()}
    for what, (slab, st, en) in slabs.items():
        match_sweep_at(variants, what, slab, st, en)
    lib = variant_libs("lz4_match", {"phases": PHASE_CLOCKS})["phases"]
    lib.lz4_match_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lz4_match_phases.restype = ctypes.c_int
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout)
    for what, (slab, st, en) in slabs.items():
        match_phases(lib, what, slab, st, en, mhz)


def match_phases(lib, what: str, slab, st, en, mhz: float) -> None:
    """Per-stream clocks of each phase (the instrumented kernel, its
    events checked against the twin): the slowest stream's phases and the
    median of each."""
    import numpy as np

    want = k_lz4.match_events_slab(slab.cpu().numpy(), st, en, force="numpy")
    call, out, rows = k_lz4.match_launch(slab, st, en, lib=lib)
    call()
    got = k_lz4.match_result(out, rows)
    if not all(np.array_equal(g, x) for g, x in zip(got, want)):
        raise AssertionError("the instrumented lz4_match differs")
    clk = np.zeros((st.size, 8), dtype=np.int64)
    build.check(lib.lz4_match_phases(clk.ctypes.data, st.size),
                "lz4_match_phases")
    total = clk[:, :7].sum(axis=1)
    worst = int(np.argmax(total))
    walk = clk[:, 5].sum() / max(int(clk[:, 7].sum()), 1)
    print(f"[variant] lz4_match phases at the {what}, cycles (us at the "
          f"{mhz:.0f} MHz max SM clock): slowest stream "
          f"({int(clk[worst, 7])} events) "
          + ", ".join(f"{n} {int(c)} ({c / mhz:.2f})"
                      for n, c in zip(PHASES, clk[worst, :7]))
          + f"; medians " + ", ".join(
              f"{n} {int(c)}" for n, c in zip(PHASES,
                                               np.median(clk[:, :7], 0)))
          + f"; walk {walk:.0f} cycles an event", flush=True)


def match_sweep_at(variants: dict, what: str, slab, st, en) -> None:
    import numpy as np

    want = k_lz4.match_events_slab(slab.cpu().numpy(), st, en, force="numpy")
    libs = dict(shipped=build.load("lz4_match"), **variants)
    times = []
    for name in in_turns(variants):
        call, out, rows = k_lz4.match_launch(slab, st, en, lib=libs[name])
        call()
        got = k_lz4.match_result(out, rows)
        if not all(np.array_equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"lz4_match {name} differs from the twin")
        times.append(f"{name} {cs.timed(torch, call)['ms'] * 1e3:.2f}")
    print(f"[variant] lz4_match at the {what} ({st.size} streams, "
          f"{want[0].size} events), us: " + ", ".join(times), flush=True)


def pages_by_cluster(k: int) -> tuple:
    """pnm_score.cu with a cluster of ``k`` blocks a page: block r of a
    cluster takes chunks r, r + k, .. of each page, and at the end the
    blocks push their maxima into block 0's shared memory (distributed
    shared memory, one remote mbarrier arrival each), which merges them."""
    return (
        ("#include <cuda_runtime.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n"),
        ("constexpr int kMaxSlots = 1024;      // pages a block takes, at most\n",
         "constexpr int kMaxSlots = 1024;      // pages a block takes, at most\n"
         f"constexpr int kCtasPerPage = {k};\n"
         "namespace cg = cooperative_groups;\n"
         "__device__ __forceinline__ void cluster_arrive() {\n"
         '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
         '"memory");\n}\n'
         "__device__ __forceinline__ void cluster_wait() {\n"
         '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
         "}\n"),
        ("  const int blocks = gridDim.x;\n  const int blk = blockIdx.x;\n",
         "  constexpr int K = kCtasPerPage;\n"
         "  __shared__ __align__(8) uint64_t merged;  // block 0: the pushes\n"
         "  __shared__ float inbox[K - 1][kMaxSlots]; // block 0: peers' maxima\n"
         "  const int rank = static_cast<int>(cg::this_cluster().block_rank());\n"
         "  const int blocks = gridDim.x / K;\n  const int blk = blockIdx.x / K;\n"),
        ("  const int chunks = slots * per_page;\n"
         "  auto chunk_page = [&](int i) { return i / per_page; };\n"
         "  auto chunk_row = [&](int i) { return (i % per_page) * R; };\n",
         "  const int mine = per_page > rank ? (per_page - rank - 1) / K + 1 : 0;\n"
         "  const int chunks = slots * mine;\n"
         "  auto chunk_page = [&](int i) { return i / mine; };\n"
         "  auto chunk_row = [&](int i) { return (rank + K * (i % mine)) * R; };\n"),
        ("    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);\n",
         "    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);\n"
         "    if (rank == 0)\n"
         '      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\\n" ::"r"(\n'
         '                       smem_addr(&merged)), "r"(K - 1) : "memory");\n'),
        ("  for (int i = tid; i < slots; i += kThreads) {\n    vl[i]",
         "  cluster_arrive();        // peers push once block 0 runs\n"
         "  for (int i = tid; i < slots; i += kThreads) {\n    vl[i]"),
        ("  for (int i = tid; i < slots; i += kThreads)\n"
         "    out[blk + (long long)i * blocks] = pm[i];\n}\n",
         "  cluster_wait();\n"
         "  if (rank != 0) {\n"
         "    float* box = cg::this_cluster().map_shared_rank(inbox[rank - 1], 0);\n"
         "    for (int i = tid; i < slots; i += kThreads) box[i] = pm[i];\n"
         "    __syncthreads();\n"
         "    if (tid == 0) {\n"
         "      uint32_t remote;\n"
         '      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\\n"\n'
         '                   : "=r"(remote) : "r"(smem_addr(&merged)));\n'
         '      asm volatile("fence.acq_rel.cluster;\\n"\n'
         '                   "mbarrier.arrive.release.cluster.shared::cluster.b64 _, "\n'
         '                   "[%0];\\n" ::"r"(remote) : "memory");\n'
         "    }\n"
         "    return;\n"
         "  }\n"
         "  uint32_t done = 0;\n"
         "  while (!done) {\n"
         "    asm volatile(\n"
         '        "{\\n.reg .pred p;\\n"\n'
         '        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "\n'
         '        "0;\\nselp.u32 %0, 1, 0, p;\\n}\\n"\n'
         '        : "=r"(done) : "r"(smem_addr(&merged)) : "memory");\n'
         "  }\n"
         "  for (int i = tid; i < slots; i += kThreads) {\n"
         "    float m = pm[i];\n"
         "    for (int r = 1; r < K; ++r) m = nan_max(m, inbox[r - 1][i]);\n"
         "    out[blk + (long long)i * blocks] = m;\n"
         "  }\n}\n"),
        ("  const int R = max(1, min(kStageBytes / (2 * C), T));\n",
         "  const int R = max(1, min(kStageBytes / (2 * C),\n"
         "                           (T + kCtasPerPage - 1) / kCtasPerPage));\n"),
        ("  const int blocks = max(min(P, kCtasPerSm * sms), (P + kMaxSlots - 1) /\n"
         "                                                       kMaxSlots);\n",
         "  const int blocks = max(min(P, max(1, kCtasPerSm * sms / kCtasPerPage)),\n"
         "                         (P + kMaxSlots - 1) / kMaxSlots);\n"),
        ("  kern<<<blocks, kThreads, smem, stream>>>(x, vl, dg, o, P, T, C, R, bulk);\n"
         "  return cudaSuccess;\n",
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(blocks * kCtasPerPage);\n"
         "  cfg.blockDim = dim3(kThreads);\n"
         "  cfg.dynamicSmemBytes = smem;\n"
         "  cfg.stream = stream;\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = kCtasPerPage;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  return cudaLaunchKernelEx(&cfg, kern, x, vl, dg, o, P, T, C, R, bulk);\n"),
    )


# Variants of pnm_score.cu (shipped: a block a page, 2 stages of at most
# 16 KiB, 32 values a lane in flight, 4 blocks an SM, 256 threads).
SCORE_VARIANTS = {
    **{f"k{k}": pages_by_cluster(k) for k in (2, 4)},
    **{f"s{n}": const_variant("pnm_score", kStages=n) for n in (3, 4)},
    **{f"v{n}": const_variant("pnm_score", kRowValues=n) for n in (8, 16)},
    **{f"sm{n}": const_variant("pnm_score", kCtasPerSm=n) for n in (2, 3)},
    "b8k": const_variant("pnm_score", kStageBytes=8192),
    "t512": const_variant("pnm_score", kThreads=512),
}

# kv_delta.cu with the mode of each channel found by one warp walking the
# channel's distinct exponents in increasing order: a warp minimum of
# the exponents above the last one found, then a warp count of it; the
# first of the largest counts wins, so ties go to the smallest exponent.
MODE_BY_WARP = (
    ("""__device__ __forceinline__ void window_modes(const Words<S>& w,""",
     """__device__ __forceinline__ void window_modes(const uint16_t* tile,
                                             const Words<S>& w,"""),
    ("window_modes(w, bins,", "window_modes(tile, w, bins,"),
    ("""  if (ci < tc) {
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (8 * (g + kFwdGroups * j) + k < n)
          bins[exponent(w[j][k]) * kFwdChannels + ci] = 0;
  }
  __syncthreads();
  Key mine = 0;
  if (ci < tc) {
    count_words(w, bins, n, ci, g, mine);
    atomicMax(&best[ci], mine);
  }
""", """  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int cc = warp; cc < tc; cc += kFwdThreads / 32) {
    int last = -1;
    Key top = 0;
    while (true) {
      unsigned lo = 256;
      for (int t = lane; t < n; t += 32) {
        const int e = exponent(tile[t * kFwdChannels + cc]);
        if (e > last && e < (int)lo) lo = e;
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      if (lo == 256) break;
      unsigned cnt = 0;
      for (int t = lane; t < n; t += 32)
        cnt += exponent(tile[t * kFwdChannels + cc]) == (int)lo;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      const Key k = mode_key<Key>(cnt, lo);
      top = k > top ? k : top;
      last = lo;
    }
    if (lane == 0) best[cc] = top;
  }
"""),
)

# Variants of kv_delta.cu's forward (shipped: 32 channels and 8 token
# groups a block, registers for 4 blocks an SM, the counted bins).
FORWARD_VARIANTS = {
    "fwd-c64g4": const_variant("kv_delta", kFwdChannels=64, kFwdGroups=4),
    "fwd-c64g8": const_variant("kv_delta", kFwdChannels=64, kFwdGroups=8),
    "fwd-c32g4": const_variant("kv_delta", kFwdGroups=4),
    "fwd-c32g16": const_variant("kv_delta", kFwdGroups=16),
    **{f"fwd-mb{n}": const_variant("kv_delta", kFwdMinBlocks=n)
       for n in (1, 6)},
    "fwd-warp-mode": MODE_BY_WARP,
}


# bitplane_pack.cu with the planes by ballot: a warp per 1024 elements (the
# shipped grid at 4 runs a thread), lane l holding element 32 r + l in
# round r; __ballot_sync of bit p gives 4 bytes of plane p's row (element
# 32 r + l in bit l, so __brev and a byte swap put each byte's first
# element in its MSB), and lane r keeps round r's words to store.
PACK_BY_BALLOT = const_variant("bitplane_pack", kGroups=4) + (
    ("}  // namespace\n", """\
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_by_ballot(const uint4* __restrict__ x4, uint8_t* __restrict__ out,
               long long n8) {
  const uint16_t* x = reinterpret_cast<const uint16_t*>(x4);
  const long long n = 8 * n8;
  const int lane = threadIdx.x & 31;
  const long long e0 =
      ((blockIdx.x * (long long)kThreads + threadIdx.x) >> 5) * 1024;
  if (e0 >= n) return;
  uint32_t e[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const long long i = e0 + 32 * r + lane;
    e[r] = i < n ? x[i] : 0u;
  }
  uint32_t mine[16];
#pragma unroll
  for (int r = 0; r < 32; ++r)
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, (e[r] >> p) & 1u);
      if (lane == r) mine[p] = __byte_perm(__brev(m), 0, 0x0123);
    }
  const long long c = e0 / 8 + 4 * lane;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    if (VEC && c + 4 <= n8) {
      *reinterpret_cast<uint32_t*>(out + p * n8 + c) = mine[p];
      continue;
    }
    for (int b = 0; b < 4; ++b)
      if (c + b < n8)
        out[p * n8 + c + b] = static_cast<uint8_t>(mine[p] >> (8 * b));
  }
}

}  // namespace
"""),
    ("pack_planes_kernel<kGroups, true><<<", "pack_by_ballot<true><<<"),
    ("pack_planes_kernel<kGroups, false><<<", "pack_by_ballot<false><<<"),
)

# Variants of bitplane_pack.cu (shipped: 32 threads a block, 4 runs of 8
# elements a thread, the register transpose) and of lz4_prep.cu (shipped:
# 256 threads a block, 1 round of 4 positions a lane).
PACK_VARIANTS = {
    **{f"t{n}": const_variant("bitplane_pack", kThreads=n)
       for n in (64, 128, 256)},
    **{f"g{n}": const_variant("bitplane_pack", kGroups=n) for n in (2, 8)},
    "ballot": PACK_BY_BALLOT,
}
PREP_VARIANTS = {
    **{f"r{n}": const_variant("lz4_prep", kRounds=n) for n in (2, 4)},
    **{f"t{n}": const_variant("lz4_prep", kThreads=n) for n in (128, 512)},
    "r4t128": const_variant("lz4_prep", kRounds=4, kThreads=128),
}


def warm_cold(call, kernel: str) -> str:
    """``back to back/cold`` device us of ``call`` (the cold time of the
    kernels whose name holds ``kernel``)."""
    cold = cs.cold_ms(torch, call, kernel)
    cold = "-" if cold is None else f"{cold * 1e3:.2f}"
    return f"{cs.timed(torch, call)['ms'] * 1e3:.2f}/{cold}"


def pack_planes_of(n: int, seed: int):
    """A KV-like slab of ``n`` elements and its planes (the plain pack)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = cs.kv_like(torch, n, gen)
    return x, k_bitplane.pack_planes_plain(x)


def pack_sweep(variants: dict) -> None:
    """The pack at the flush slab and at a 896 x 4864 weight, shipped and
    variants, each call held bit-equal to the plain version."""
    floor = cs.launch_floor(torch)
    print(f"[variant] launch floor: a 16-byte zero_() {floor['ms'] * 1e3:.2f} "
          f"us device ({floor['ms_from']})", flush=True)
    libs = dict(shipped=build.load("bitplane_pack"), **variants)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (cs.SLAB_ELEMS, cs.PACK_LONG):
        x, want = pack_planes_of(n, 23)
        b, _ = cs.bound_ms(4 * n, 64 * n)
        times = []
        for name in in_turns(variants):
            out = torch.empty_like(want)

            def call(lib=libs[name], out=out):
                build.check(lib.pack_planes_u16(
                    x.data_ptr(), out.data_ptr(), n, 0, stream),
                    "bitplane_pack")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"bitplane_pack {name} ({n} elements) "
                                     "differs from its plain version")
            times.append(f"{name} {warm_cold(call, 'pack')}")
        print(f"[variant] bitplane_pack {n} elements (bound {b * 1e3:.3f}), "
              "us back to back/cold: " + ", ".join(times), flush=True)


def prep_sweep(variants: dict) -> None:
    """The prep over the planes of the flush slab and of a 896 x 4864
    weight, with and without run flags, shipped and variants (the parent
    only with them: its kernel has no way to skip them), each call held
    bit-equal to the plain version."""
    libs = dict(shipped=build.load("lz4_prep"), **variants)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (cs.SLAB_ELEMS, cs.PACK_LONG):
        buf = pack_planes_of(n, 24)[1].reshape(-1)
        m = buf.numel()
        want = k_lz4.prep_plain(buf)
        for runb in (True, False):
            b, _ = cs.bound_ms((13 if runb else 9) * m, 10 * m)
            times = []
            for name in in_turns(variants):
                if name == "parent" and not runb:
                    continue
                outs = [torch.empty(m, dtype=torch.int32, device="cuda")
                        for _ in range(3)]

                def call(lib=libs[name], outs=outs):
                    build.check(lib.lz4_prep(
                        buf.data_ptr(), outs[0].data_ptr(),
                        outs[1].data_ptr(),
                        outs[2].data_ptr() if runb else None, m, 0, stream),
                        "lz4_prep")

                call()
                torch.cuda.synchronize()
                if not all(torch.equal(o, w)
                           for o, w in zip(outs, want[: 2 + runb])):
                    raise AssertionError(f"lz4_prep {name} ({m} B, runb "
                                         f"{runb}) differs from its plain "
                                         "version")
                times.append(f"{name} {warm_cold(call, 'lz4_prep')}")
            print(f"[variant] lz4_prep {m} B {'with' if runb else 'without'} "
                  f"run flags (bound {b * 1e3:.3f}), us back to back/cold: "
                  + ", ".join(times), flush=True)


def score_sweep(variants: dict) -> None:
    """Page scoring at the served and a long-context gather, shipped and
    variants, each call held bit-equal to the plain version."""
    import numpy as np

    from repro_torch.kernels import pnm_score as k_pnm

    libs = dict(shipped=build.load("pnm_score"), **variants)
    rng = np.random.default_rng(21)
    C = cs.CHANNELS
    digest = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).cuda()
    for P in (cs.PAGES, cs.LONG_PAGES):
        T = cs.PAGE_ROWS
        x = rng.standard_normal((P, T, C), dtype=np.float32) * 0.7
        pages = torch.from_numpy(((x.view(np.uint32) >> 16).astype(
            np.uint16)).view(np.int16)).cuda()
        valid = torch.full((P,), T, dtype=torch.int32, device="cuda")
        want = k_pnm.page_scores_plain(pages, valid, digest)
        b, _ = cs.bound_ms(cs.score_bytes(P), 2 * P * T * C)
        times = []
        for name in in_turns(variants):
            out = torch.empty(P, dtype=torch.float32, device="cuda")

            def call(lib=libs[name], out=out):
                build.check(lib.pnm_score(
                    pages.data_ptr(), valid.data_ptr(), digest.data_ptr(),
                    out.data_ptr(), P, T, C, 0,
                    torch.cuda.current_stream().cuda_stream), "pnm_score")

            call()
            torch.cuda.synchronize()
            if not cs.same_scores(torch, out, want):
                raise AssertionError(f"pnm_score {name} ({P} pages) differs "
                                     "from its plain version")
            times.append(f"{name} {cs.timed(torch, call)['ms'] * 1e3:.2f}")
        print(f"[variant] pnm_score {P} x {T} x {C} (bound "
              f"{b * 1e3:.3f}), us: " + ", ".join(times), flush=True)


def forward_sweep(variants: dict) -> None:
    """The KV forward (finding beta) at the served and a long-context
    flush, shipped and variants, each call held bit-equal to the plain
    version."""
    libs = dict(shipped=build.load("kv_delta"), **variants)
    n, C = cs.WINDOW, cs.CHANNELS
    for B in (cs.FLUSH_WINDOWS, cs.LONG_WINDOWS):
        x = cs.kv_windows(torch, B, n, 22)
        want, want_beta = k_kv.kv_forward_plain(x)
        elems = B * n * C
        b, _ = cs.bound_ms(4 * elems + B * C, 12 * elems)
        times = []
        for name in in_turns(variants):
            out = torch.empty((B, C, n), dtype=torch.int16, device="cuda")
            beta = torch.empty((B, C), dtype=torch.uint8, device="cuda")

            def call(lib=libs[name], out=out, beta=beta):
                build.check(lib.kv_delta_fwd(
                    x.data_ptr(), out.data_ptr(), beta.data_ptr(), B, n, C,
                    1, 0, torch.cuda.current_stream().cuda_stream),
                    "kv_delta_fwd")

            call()
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(beta, want_beta)):
                raise AssertionError(f"kv_delta_fwd {name} ({B} windows) "
                                     "differs from its plain version")
            times.append(f"{name} {cs.timed(torch, call)['ms'] * 1e3:.2f}")
        print(f"[variant] kv_delta_fwd {B} x {n} x {C} (bound "
              f"{b * 1e3:.3f}), us: " + ", ".join(times), flush=True)


SWEEPS = ("attention", "matmul", "kv_read", "inverse", "match", "score",
          "forward", "pack", "prep")


def main() -> None:
    import argparse
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run")
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's src/repro_torch/csrc")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if only - set(SWEEPS):
        cs.fail(f"unknown sweeps {sorted(only - set(SWEEPS))}")
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(cs.card_line(), flush=True)
    build.build_all(("decode_attn", "elastic_matmul", "bitplane_unpack",
                     "kv_delta", "bitplane_pack", "lz4_prep", "lz4_match",
                     "pnm_score"))

    def libs(source, variants, sweep):
        if sweep not in only:
            return {}
        out = variant_libs(source, variants)
        if args.parent is not None and sweep in ("score", "forward", "pack",
                                                 "prep"):
            out.update(variant_libs(source, {"parent": ()}, args.parent))
        return out

    matmul = libs("elastic_matmul", MATMUL_VARIANTS, "matmul")
    kv = libs("bitplane_unpack", KV_READ_VARIANTS, "kv_read")
    inv = libs("kv_delta", INVERSE_VARIANTS, "inverse")
    match = libs("lz4_match", MATCH_VARIANTS, "match")
    score = libs("pnm_score", SCORE_VARIANTS, "score")
    fwd = libs("kv_delta", FORWARD_VARIANTS, "forward")
    pack = libs("bitplane_pack", PACK_VARIANTS, "pack")
    prep = libs("lz4_prep", PREP_VARIANTS, "prep")
    if "attention" in only:
        attention_sweep()
    if "matmul" in only:
        matmul_m1(matmul)
    if "kv_read" in only:
        kv_read(kv)
    if "inverse" in only:
        inverse(inv)
    if "match" in only:
        match_sweep(match)
    if "score" in only:
        score_sweep(score)
    if "forward" in only:
        forward_sweep(fwd)
    if "pack" in only:
        pack_sweep(pack)
    if "prep" in only:
        prep_sweep(prep)


if __name__ == "__main__":
    main()
