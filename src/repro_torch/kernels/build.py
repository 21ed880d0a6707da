"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  The library name carries a hash of its source and of every
shared header in ``csrc/`` (``*.cuh``), so an edited kernel or header
rebuilds and a stale library is never loaded.  Libraries go to
``src/repro_torch/_build/`` (git-ignored), built at first use from the
sources in the checkout; :func:`build_all` starts one ``nvcc`` per source
together, which is what a caller that needs every kernel should run
first, and waits for them; :func:`start_all` starts them and returns, so
a caller works while they compile and each :func:`load` waits for its
own library alone.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("bitplane_pack", "lz4_prep", "decode_attn", "pnm_score",
           "kv_delta", "bitplane_unpack", "elastic_matmul", "lz4_match")
# Kernels, by the name their launches are counted under (kv_delta.cu
# holds two; bitplane_unpack.cu's standalone and fused KV read launches
# both count as bitplane_unpack; decode_attn.cu's entry with the length in
# device memory, which the serving engine's captured decode step
# launches, counts as decode_attn_devlen).
KERNELS = ("bitplane_pack", "lz4_prep", "decode_attn", "pnm_score",
           "kv_delta_fwd", "kv_delta_inv", "bitplane_unpack",
           "elastic_matmul", "lz4_match", "decode_attn_devlen")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_ulonglong
# C launchers of each library: {function: argtypes}; each returns
# cudaError_t.
SIGNATURES = {
    "bitplane_pack": {"pack_planes_u16": (_P, _P, _L, _I, _P)},
    "lz4_prep": {"lz4_prep": (_P, _P, _P, _P, _L, _I, _P)},
    "decode_attn": {"decode_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _I, _I, _P),
                    "decode_attn_devlen": (_P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _I, _I, _I, _F, _I, _I,
                                           _P)},
    "pnm_score": {"pnm_score": (_P, _P, _P, _P, _I, _I, _I, _I, _P)},
    "kv_delta": {"kv_delta_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
                 "kv_delta_inv": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _P)},
    "bitplane_unpack": {"unpack_planes_u16": (_P, _P, _L, _I, _U, _I, _I, _I,
                                              _I, _P),
                        "unpack_kv_windows": (_P, _L, _I, _U, _P, _P, _P, _I,
                                              _I, _I, _I, _I, _I, _I, _P)},
    "elastic_matmul": {"elastic_matmul": (_P, _P, _L, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _P)},
    "lz4_match": {"lz4_match": (_P, _P, _P, _I, _I, _P, _P, _L, _I, _P),
                  "lz4_match_tile_max": (), "lz4_match_table_bytes": ()},
}

# Launches per kernel: each wrapper adds one where it launches its kernel
# and nowhere else (a CUDA graph's replay adds what its capture counted:
# ``runtime.serving.DecodeGraph``), so a run can show that its path went
# through the card.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc jobs started and not yet waited for: {name: (library, temp, process)}
_PENDING: Dict[str, tuple] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start_all(names=SOURCES) -> None:
    """Start one ``nvcc`` per missing kernel library, all together, and
    return: :func:`load` or :func:`build_all` waits for each.  Each
    library is written under a temporary name and renamed into place, so
    a concurrent or interrupted build never leaves a partial one; a job
    still running when the process exits is killed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _LOCK:
        for name in names:
            out = lib_path(name)
            if name in _PENDING or out.is_file():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            # niced: a caller working meanwhile (timing kernels under
            # the profiler) keeps the host's cores it needs
            _PENDING[name] = (out, tmp, subprocess.Popen(
                ["nice", "-n", "10", *cmd], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))


def _finish(name: str) -> None:
    """Wait for ``name``'s nvcc job (``_LOCK`` held) and move its library
    into place; raise with the compiler's output if it failed."""
    out, tmp, proc = _PENDING.pop(name)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


@atexit.register
def _kill_pending() -> None:
    for _, _, proc in _PENDING.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def build_all(names=SOURCES) -> List[Path]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together, and wait for them.  Returns the library paths."""
    start_all(names)
    with _LOCK:
        for name in names:
            if name in _PENDING:
                _finish(name)
    return [lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        start_all((name,))
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if name in _PENDING:
                _finish(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a ``cudaError_t`` other than 0."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
