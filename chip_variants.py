"""Design alternatives of the port's decode attention and elastic matmul,
timed on one NVIDIA GPU beside the shipped choice.

Run from the repository root on a machine with a card:

    python3 chip_variants.py

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

from repro_torch.kernels import bitplane as k_bitplane  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as k_attn  # noqa: E402
from repro_torch.kernels import elastic_matmul as k_mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

VALID_LENS = (576, 1024, 1536, 2048, 3072, 4096, 4097, 8192, 16384,
              32768)
CHUNKS = (32, 64, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024)
KERNEL_SPLITS = 64           # blocks a row the kernel takes (kMaxSplits)


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


def matmul_variant_libs() -> dict:
    """Build every variant of elastic_matmul.cu, one nvcc each, together."""
    src = (build.CSRC / "elastic_matmul.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in MATMUL_VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"elastic_matmul.cu: {old!r} moved")
            text = text.replace(old, new)
        cu = out / f"elastic_matmul_{name}.cu"
        cu.write_text(text)
        so = out / f"libelastic_matmul_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        fn = ctypes.CDLL(str(so)).elastic_matmul
        fn.argtypes = list(build.SIGNATURES["elastic_matmul"]["elastic_matmul"])
        fn.restype = ctypes.c_int
        libs[name] = fn
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
        for name, fn in variants.items():
            order += [(name, fn), (name, fn)]
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


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(cs.card_line(), flush=True)
    build.build_all(("decode_attn", "elastic_matmul"))
    variants = matmul_variant_libs()
    attention_sweep()
    matmul_m1(variants)


if __name__ == "__main__":
    main()
