"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell's
step as rank 0 of a fake process group — the reference's
``repro.launch.dryrun``, without a compiler.

Each cell's step (``train_step``, ``prefill_step`` or ``serve_step``)
runs on tensors of the ``meta`` device, placed as DTensors on the
production meshes of a ``fake`` process group, which allocates nothing
and communicates nothing:

  * single-pod: 16×16 = 256 ranks, dims (data, model)
  * multi-pod : 2×16×16 = 512 ranks, dims (pod, data, model)

One ``TorchDispatchMode`` sees every aten op this rank runs, at its
local shapes (a DTensor op is let through to DTensor, whose local ops
and collectives come back to the mode), and records for the cell:

  * ``flops``: ``torch.utils.flop_counter``'s count of each op;
  * ``bytes_accessed``: each op's input and output bytes (views and
    allocations move nothing) — eager, with no fusion;
  * ``collectives``: bytes (each collective's result, as the reference
    takes them) and counts by the reference's kinds, from the
    functional and the ``c10d`` collectives alike; each record also
    keeps the group's global ranks and its phase (``backward`` inside
    autograd's backward, ``optimizer`` inside ``optim/``, else
    ``forward``);
  * memory: ``argument_size_in_bytes`` (the inputs' local shards),
    ``output_size_in_bytes`` (outputs that alias no input),
    ``temp_size_in_bytes`` (the peak of live bytes the step creates)
    and ``device_bytes_total`` (arguments + temp);
  * ``kernel_calls``: the decode-attention kernel's calls, whose bytes
    and FLOPs (its bound's: K and V rows below the valid length read
    once, q read, the f32 output written) are added to the totals,
    since a kernel's launch is not an aten op.

A decode cell's ``cache_pos`` is a concrete CPU scalar, ``seq_len - 1``:
a full cache, the largest attention (the reference's abstract input
carries no value).  FLOPs, temp bytes and the choice of collectives are
the port's own and are not held to XLA's: its SPMD partitioner and its
fusion are not the port's design; the argument bytes are the same.

The trip-count correction (the reference's 2x unroll): where a whole
trace is too slow, the step is traced at cut depths — the stack at 1
and 2 layers past the dense first ones (and 3 for a train step); the
hybrid, whose units are its Mamba2 layers and its shared-block
applications, at 2, 3 and 4 layers with the block applied every second
layer (and 5 for a train step) — and, for the SSM families' prompts,
with each selective scan cut to 2 and 3 of its steps
(``models.layers.scan_steps``; every other op runs at the prompt's
length), then extrapolated: affinely in the layers, applications and
steps (``total = r1 + (L - 1)(r2 - r1)``), and for a train step
quadratically in the stacked layers, since each layer's slice of a
stacked parameter gets a gradient the size of the stack.  FLOPs,
bytes, collective bytes and counts and kernel calls are sums over the
ops, and their extrapolation is exact; the temp and output bytes take
the affine fit as an estimate.  Argument bytes come from the
full-depth inputs.  ``extrapolated`` says which cuts a cell took.
Cells cut: every cell of a stack deeper than :data:`WHOLE_LAYERS`
layers (nemotron-4-340b, grok-1-314b, qwen1.5-32b, llava-next-34b,
hubert-xlarge, stablelm-12b, falcon-mamba-7b, zamba2-7b) in the layers,
and the SSM families' train_4k and prefill_32k cells in the layers and
the scan's steps.

``device="cuda"`` (``--real-rank``) runs the same cell with real
tensors on the card as rank 0 of the fake world: the collectives leave
their outputs unwritten, so the inputs are random (from a seed) and no
value is compared; the record adds the measured peak, the step's wall
time and the kernel launches beside the trace's numbers.  That step
runs once and eagerly, not through ``launch.train.TrainGraph``: a cell
measures one step, which a CUDA graph would record but never replay.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh single --real-rank
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from fractions import Fraction
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, applicable_shapes
from ..configs.base import ArchConfig, ShapeConfig
from ..models import layers
from ..models.sharding import NamedSharding, is_dtensor, local_chunk
from ..tree import map_tree
from . import mesh as mesh_lib
from .steps import (
    input_specs, make_prefill_step, make_serve_step, make_train_step,
)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# collective op name (any of the c10d namespaces) → the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_C10D = ("c10d", "c10d_functional", "_c10d_functional",
         "_c10d_functional_autograd")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
                    "monitored_barrier_")
# allocations: their outputs are live bytes, but nothing is moved
_ALLOCS = ("empty", "empty_strided", "new_empty", "new_empty_strided",
           "empty_like")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OPTIM = os.path.join(_PKG, "optim") + os.sep
_QUIET = (os.path.join(_PKG, "models", "sharding.py"),
          os.path.abspath(__file__))

# stacks deeper than this are traced at 1 and 2 layers and extrapolated
WHOLE_LAYERS = 32
# steps the SSM families' scans are traced at (``layers.scan_steps``);
# every step past the first costs the same
SCAN_STEPS = (2, 3)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def empty_collectives() -> dict:
    return {**{k: 0 for k in COLLECTIVES},
            **{f"n_{k}": 0 for k in COLLECTIVES}, "total": 0}


def _group_ranks(func, args, kwargs) -> list:
    """The global ranks of a collective's group: a ``c10d`` op carries
    the group, a functional one its name."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                a = dist.ProcessGroup.unbox(a)
            except RuntimeError:        # a ReduceOp, not the group
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (KeyError, ValueError, RuntimeError):
                continue
    raise RuntimeError(f"no process group in the arguments of {func}")


def _site() -> str:
    """The innermost frame of the port outside the collective helpers:
    where a collective comes from."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PKG) and not name.startswith(_QUIET):
            return (f"{os.path.relpath(name, _PKG)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def _phase() -> str:
    if torch._C._current_graph_task_id() != -1:
        return "backward"
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(_OPTIM):
            return "optimizer"
        f = f.f_back
    return "forward"


def _meta_join(func, args, kwargs):
    """``stack`` / ``cat`` of meta tensors of one dtype, shaped here: the
    meta kernels check every input in Python, which for a scan's
    thousands of steps costs seconds a layer.  None for anything else."""
    if func not in (torch.ops.aten.stack.default, torch.ops.aten.cat.default):
        return None
    ts = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    if not ts or any(not t.is_meta or t.dtype != ts[0].dtype
                     or t.shape != ts[0].shape for t in ts):
        return None
    shape = list(ts[0].shape)
    if func is torch.ops.aten.stack.default:
        dim = dim % (len(shape) + 1)
        shape.insert(dim, len(ts))
    else:
        dim = dim % len(shape)
        shape[dim] *= len(ts)
    return torch.empty(shape, dtype=ts[0].dtype, device="meta")


class Accounting(TorchDispatchMode):
    """FLOPs, bytes accessed, collectives and live bytes of what this
    rank runs, at its local shapes (see the module docstring).  Only
    storages on ``device_type`` count toward the live bytes."""

    def __init__(self, device_type: str = "meta"):
        super().__init__()
        self.device_type = device_type
        self.flops = 0
        self.bytes_accessed = 0
        self.kernel_calls = 0
        self.collectives = empty_collectives()
        self.records: list = []
        self.live = 0
        self.peak = 0
        self._owned: dict = {}

    def _track(self, t: torch.Tensor):
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        if id(st) in self._owned:
            return
        n = st.nbytes()
        self._owned[id(st)] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st))

    def _free(self, key):
        self.live -= self._owned.pop(key, 0)

    def add_kernel(self, nbytes: int, flops: int):
        self.kernel_calls += 1
        self.bytes_accessed += nbytes
        self.flops += flops

    def _collective(self, func, kind, args, kwargs, out):
        ns = func.namespace
        res = _tensors(out if ns != "c10d" else args[0])
        nbytes = sum(_nbytes(t) for t in res)
        self.collectives[kind] += nbytes
        self.collectives[f"n_{kind}"] += 1
        self.collectives["total"] += nbytes
        self.records.append({
            "op": f"{ns}.{func._opname}", "kind": kind, "bytes": nbytes,
            "ranks": _group_ranks(func, args, kwargs), "phase": _phase(),
            "site": _site()})
        if ns != "c10d":
            for t in res:
                self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor: see its local ops
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)    # DTensor's shape propagation
        out = _meta_join(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns in _C10D:
            if name in _NOT_COLLECTIVES:
                return out
            kind = _KINDS.get(name)
            if kind is None:
                raise NotImplementedError(f"collective {ns}.{name} has no "
                                          "kind in the dry run's table")
            self._collective(func, kind, args, kwargs, out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view:
            return out
        outs = _tensors(out)
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if name not in _ALLOCS:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + (0 if aliased else sum(_nbytes(t) for t in outs))
        if not aliased:
            for t in outs:
                self._track(t)
        return out


@contextlib.contextmanager
def counted_attention(acc: Accounting):
    """Count the decode-attention kernel's calls into ``acc``, with its
    bytes and FLOPs where the mode cannot see its work (a meta trace,
    the card's launch; on the CPU its plain version's ops are seen)."""
    real = layers.decode_attention

    def wrapped(q, k, v, valid_len, scale=None):
        out = real(q, k, v, valid_len, scale)
        if q.device.type == "cpu":
            acc.kernel_calls += 1
        else:
            B, H, hd = q.shape
            KV = k.shape[2]
            nbytes = B * (2 * valid_len * KV * hd * k.element_size()
                          + H * hd * q.element_size() + H * hd * 4)
            acc.add_kernel(nbytes, B * 4 * H * valid_len * hd)
        return out

    layers.decode_attention = wrapped
    try:
        yield
    finally:
        layers.decode_attention = real


# ---------------------------------------------------------------------------
# the fake world and the cell's inputs
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    for the block, destroyed after.  Raises if a group is
    already running or the backend cannot start."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry "
                           "run starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, specs: dict):
    """The reference's: ``(shardings of every input, rules)`` — params,
    the moments and the error buffer like the params, the cache by
    :func:`..mesh.cache_shardings`, the batch over the batch dims unless
    the global batch is 1; scalars replicated."""
    rules = mesh_lib.rules_for(cfg, shape, mesh)
    pshard = mesh_lib.param_shardings(cfg, rules)
    ba = mesh_lib.batch_axes(mesh)
    repl = NamedSharding(mesh, ())

    def batch_shard(leaf):
        if leaf.ndim == 0:
            return repl
        if shape.global_batch == 1:
            return NamedSharding(mesh, (None,) * leaf.ndim)
        return NamedSharding(mesh, (ba,) + (None,) * (leaf.ndim - 1))

    out = {"params": pshard}
    if shape.kind == "train":
        out["opt_state"] = {"mu": pshard, "nu": pshard, "step": repl}
        out["error_buf"] = pshard
    if shape.is_decode:
        out["cache"] = mesh_lib.cache_shardings(cfg, rules, specs["cache"])
    out["batch"] = {k: batch_shard(v) for k, v in specs["batch"].items()}
    return out, rules


def _fill(local: torch.Tensor, name: str, vocab: int, gen) -> torch.Tensor:
    """Random values for a real-rank input: token ids below ``vocab``,
    small normals for floats (fp8 through bf16), zeros for other ints."""
    if name in ("tokens", "labels"):
        return local.random_(0, vocab, generator=gen)
    if local.dtype.is_floating_point:
        if local.element_size() == 1:
            src = torch.empty(local.shape, dtype=torch.bfloat16,
                              device=local.device)
            return local.copy_(src.normal_(0, 0.02, generator=gen))
        return local.normal_(0, 0.02, generator=gen)
    return local.zero_()


def place(spec: torch.Tensor, sharding: NamedSharding, device,
          name: str = "", vocab: int = 0, gen=None):
    """``spec`` (a meta tensor of the global shape) as this rank's input:
    a DTensor of ``sharding`` whose local shard lives on ``device`` (left
    empty on meta, else filled from ``gen``); a scalar as a plain
    tensor."""
    if spec.ndim == 0:
        return torch.zeros((), dtype=spec.dtype, device=device)
    shard = local_chunk(spec, sharding.mesh, sharding.placements)
    loc = torch.empty(shard.shape, dtype=spec.dtype, device=device)
    if device.type != "meta":
        loc = _fill(loc, name, vocab, gen)
    return DTensor.from_local(loc, sharding.mesh, sharding.placements,
                              run_check=False, shape=spec.shape,
                              stride=spec.stride())


def cell_inputs(cfg, shape, mesh, device):
    """``(args, rules)``: the cell's step arguments in order, placed (a
    real rank's filled from seed 0)."""
    specs = input_specs(cfg, shape)
    sh, rules = cell_shardings(cfg, shape, mesh, specs)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)

    def tree(name):
        return map_tree(lambda spec, sharding: place(
            spec, sharding, device, gen=gen), specs[name], sh[name])

    batch = {k: place(v, sh["batch"][k], device, k, cfg.vocab, gen)
             for k, v in specs["batch"].items()}
    if shape.is_decode:
        batch["cache_pos"] = torch.tensor(shape.seq_len - 1,
                                          dtype=torch.int32)
    if shape.kind == "train":
        args = (tree("params"), tree("opt_state"), tree("error_buf"), batch)
    elif shape.is_decode:
        args = (tree("params"), batch, tree("cache"))
    else:
        args = (tree("params"), batch)
    return args, rules


def argument_bytes(args, cfg: ArchConfig) -> int:
    """The inputs' bytes on this rank: each DTensor's local shard.  A
    decode cell's ``cache_pos`` counts where the step uses a position, as
    the reference's compiled cell counts it: XLA prunes it from a Mamba1
    step, which has no attention."""
    n = sum(_nbytes(_local(t)) for t in _tensors(args))
    batch = args[1] if len(args) == 3 else args[-1]     # decode: the middle
    if "cache_pos" in batch and cfg.ssm == "mamba1":
        n -= _nbytes(batch["cache_pos"])
    return n


def build_step(cfg, shape, rules):
    if shape.kind == "train":
        return make_train_step(cfg, rules=rules, grad_compression=True)[0]
    if shape.is_decode:
        return make_serve_step(cfg, rules=rules)
    return make_prefill_step(cfg, rules=rules)


def trace(cfg, shape, mesh, device) -> tuple:
    """Run the cell's step once under :class:`Accounting`: ``(the
    accounting, the bytes of its outputs that alias no input, argument
    bytes, seconds, the outputs, the inputs)``."""
    args, rules = cell_inputs(cfg, shape, mesh, device)
    step = build_step(cfg, shape, rules)
    acc = Accounting(device.type)
    t0 = time.perf_counter()
    with acc, counted_attention(acc):
        out = step(*args)
    secs = time.perf_counter() - t0
    inside = {id(_local(t).untyped_storage()) for t in _tensors(args)}
    outb = sum(_nbytes(t) for t in _tensors(out)
               if id(_local(t).untyped_storage()) not in inside)
    return acc, outb, argument_bytes(args, cfg), secs, out, args


# ---------------------------------------------------------------------------
# the trip-count correction
# ---------------------------------------------------------------------------

def scan_trip_count(cfg: ArchConfig) -> int:
    """Iterations of the reference's layer scan (its correction factor)."""
    if cfg.ssm == "mamba1" or cfg.family == "hybrid":
        return cfg.n_layers
    return cfg.n_layers - cfg.first_dense


# the hybrid's cuts apply the shared block every CUT_PERIOD layers: a
# Mamba2 layer and an application cost what they cost at any period
CUT_PERIOD = 2


def depth_cuts(cfg: ArchConfig, quadratic: bool) -> tuple:
    """``(cut n_layers, their units, the full depth's units)``: a stack's
    units are its layers past the dense first ones; the hybrid's are its
    Mamba2 layers and its shared-block applications, its cuts taken at a
    period of :data:`CUT_PERIOD` layers (2, 3 and 4 layers, and 5 for a
    train step).  A ``quadratic`` fit (a train step) takes one cut
    more."""
    if cfg.family == "hybrid":
        e = CUT_PERIOD
        cuts = (e, e + 1, 2 * e, 2 * e + 1)[:4 if quadratic else 3]
        return cuts, [(n, n // e) for n in cuts], (cfg.n_layers,
                                                  cfg.n_layers // cfg.attn_every)
    d = cfg.first_dense
    k = 3 if quadratic else 2
    return (tuple(d + i for i in range(1, k + 1)),
            [(i,) for i in range(1, k + 1)], (cfg.n_layers - d,))


def _basis(u: tuple, quadratic: bool) -> list:
    """The terms a quantity is fitted by at units ``u``: affine in the
    layers and the hybrid's applications, and in a train step quadratic
    in the stacked layers too (each layer's slice of a stacked parameter
    gets a gradient the stack's size)."""
    if len(u) == 1:
        return [1, u[0], u[0] ** 2] if quadratic else [1, u[0]]
    return [1, u[0], u[0] ** 2, u[1]] if quadratic else [1, u[0], u[1]]


def _fit(units: list, vals: list, target: tuple, quadratic: bool
         ) -> Fraction:
    """The fit of :func:`_basis` through the cuts' values (an affine fit
    through the first and last cuts, and the second for the hybrid, where
    there are more), at ``target``: exact rational elimination."""
    n = len(_basis(units[0], quadratic))
    pick = (list(range(len(units))) if n == len(units)
            else [0, len(units) - 1] if n == 2 else [0, 1, 2])
    rows = [[Fraction(x) for x in _basis(units[i], quadratic)] + [vals[i]]
            for i in pick]
    for c in range(n):
        p = next(r for r in range(c, n) if rows[r][c] != 0)
        rows[c], rows[p] = rows[p], rows[c]
        for r in range(n):
            if r != c and rows[r][c] != 0:
                f = rows[r][c] / rows[c][c]
                rows[r] = [a - f * b for a, b in zip(rows[r], rows[c])]
    coef = [rows[i][n] / rows[i][i] for i in range(n)]
    return sum(c * x for c, x in zip(coef, _basis(target, quadratic)))


# quantities that are not sums over the ops: fitted as estimates
_PEAKS = ("temp_size_in_bytes", "output_size_in_bytes")


def _summary(acc: Accounting, outb: int) -> dict:
    flat = {"flops": acc.flops, "bytes_accessed": acc.bytes_accessed,
            "kernel_calls": acc.kernel_calls,
            "temp_size_in_bytes": acc.peak, "output_size_in_bytes": outb}
    flat.update({f"collectives/{k}": v for k, v in acc.collectives.items()})
    return flat


def extrapolated_trace(cfg, shape, mesh, device, layers_cut: bool,
                       steps: Optional[tuple]) -> tuple:
    """Trace the cuts and extrapolate: ``(summary at full depth and
    length, the records of the deepest cut traced, seconds)``."""
    secs, records = 0.0, []
    quad = shape.kind == "train"
    if layers_cut:
        ns, units, target = depth_cuts(cfg, quad)
    else:
        ns, units, target = (cfg.n_layers,), None, None
    per_depth = []
    for n in ns:
        c = dataclasses.replace(cfg, n_layers=n)
        if cfg.family == "hybrid":
            c = dataclasses.replace(c, attn_every=CUT_PERIOD)
        at_steps = []
        for k in steps or (None,):
            with layers.scan_steps(k) if k else contextlib.nullcontext():
                acc, outb, _, t, out, args = trace(c, shape, mesh, device)
            del out, args
            secs += t
            records = acc.records
            at_steps.append(_summary(acc, outb))
        if steps:
            per_depth.append({key: _fit(
                [(k,) for k in steps], [Fraction(a[key]) for a in at_steps],
                (shape.seq_len,), False) for key in at_steps[0]})
        else:
            per_depth.append({k: Fraction(v) for k, v in at_steps[0].items()})
    if layers_cut:
        full = {k: _fit(units, [p[k] for p in per_depth], target,
                        quad and k not in _PEAKS) for k in per_depth[0]}
    else:
        full = per_depth[0]
    return {k: int(round(v)) for k, v in full.items()}, records, secs


def extrapolation(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Which cuts a cell takes: ``{"layers": bool, "scan_steps": tuple
    or None}`` (see the module docstring)."""
    stack = cfg.n_layers - cfg.first_dense
    ssm_prompt = (cfg.ssm in ("mamba1", "mamba2") and not shape.is_decode
                  and shape.seq_len > SCAN_STEPS[-1])
    return {"layers": stack > WHOLE_LAYERS or ssm_prompt,
            "scan_steps": SCAN_STEPS if ssm_prompt else None}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _mesh(multi_pod: bool, mesh_shape, device):
    if mesh_shape is not None:
        mesh_shape = tuple(mesh_shape)
        axes = (("pod", "data", "model") if len(mesh_shape) == 3
                else ("data", "model"))
    else:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cpu" if device.type == "meta" else device.type
    return init_device_mesh(kind, mesh_shape, mesh_dim_names=axes), mesh_shape


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, mesh_shape=None,
             device="meta", collectives: bool = True,
             keep_records: bool = False) -> dict:
    """Trace one cell (``device="meta"``), or run it whole with real
    tensors as rank 0 (``"cuda"``, or ``"cpu"``), in a fake world of the
    mesh's size started here (or the running one, which must be ``fake``
    for a trace and of that size).  ``shape_name``: a cell of
    ``SHAPES``, or a ``ShapeConfig`` (one cut from it); ``overrides``:
    ArchConfig fields replaced (perf variants, or a smoke width);
    ``mesh_shape``: (data, model) or (pod, data, model) in place of the
    production mesh; ``keep_records``: the collective records in the
    result (of the deepest cut, for an extrapolated cell)."""
    cfg = ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    dev = torch.device(device)
    world = 512 if multi_pod else 256
    if mesh_shape is not None:
        world = 1
        for n in mesh_shape:
            world *= n
    if dist.is_initialized():
        if dev.type == "meta" and dist.get_backend() != "fake":
            raise RuntimeError(f"a meta trace needs the fake backend, not "
                               f"{dist.get_backend()!r}")
        if dist.get_world_size() != world:
            raise RuntimeError(f"the running world has "
                               f"{dist.get_world_size()} ranks, the cell "
                               f"needs {world}")
        ctx = contextlib.nullcontext()
    else:
        ctx = fake_world(world)
    with ctx:
        mesh, mshape = _mesh(multi_pod, mesh_shape, dev)
        rec = {"arch": arch, "shape": shape.name,
               "global_batch": shape.global_batch,
               "mesh": "x".join(str(n) for n in mshape), "chips": world,
               "kind": shape.kind, "scan_trip_count": scan_trip_count(cfg)}
        how = (extrapolation(cfg, shape) if dev.type == "meta"
               else {"layers": False, "scan_steps": None})
        if how["layers"] or how["scan_steps"]:
            full_args, _ = cell_inputs(cfg, shape, mesh,
                                       torch.device("meta"))
            rec["argument_size_in_bytes"] = argument_bytes(full_args, cfg)
            del full_args
            summary, records, secs = extrapolated_trace(
                cfg, shape, mesh, dev, how["layers"], how["scan_steps"])
            rec["extrapolated"] = {
                "layers": (list(depth_cuts(cfg, shape.kind == "train")[0])
                           if how["layers"] else None),
                "scan_steps": (list(how["scan_steps"])
                               if how["scan_steps"] else None)}
        else:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            acc, outb, argb, secs, out, args = trace(cfg, shape, mesh, dev)
            summary, records = _summary(acc, outb), acc.records
            rec["argument_size_in_bytes"] = argb
            if dev.type != "meta":
                rec["real_rank"] = real_step(cfg, shape, args, mesh, dev)
            del out, args
        rec["trace_s"] = round(secs, 3)
        rec["flops"] = summary["flops"]
        rec["bytes_accessed"] = summary["bytes_accessed"]
        rec["kernel_calls"] = summary["kernel_calls"]
        rec["output_size_in_bytes"] = summary["output_size_in_bytes"]
        rec["temp_size_in_bytes"] = summary["temp_size_in_bytes"]
        rec["device_bytes_total"] = (rec["argument_size_in_bytes"]
                                     + rec["temp_size_in_bytes"])
        if collectives:
            rec["collectives"] = {k[len("collectives/"):]: v
                                  for k, v in summary.items()
                                  if k.startswith("collectives/")}
        if keep_records:
            rec["collective_records"] = records
    return rec


def real_step(cfg, shape, args, mesh, dev) -> dict:
    """The step again on the same real inputs, uninstrumented: its wall
    time, the peak allocated above what was allocated before it, and the
    kernel launches it made."""
    from ..kernels import build

    step = build_step(cfg, shape, mesh_lib.rules_for(cfg, shape, mesh))
    build.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    res = {"step_s": round(wall, 4), "launches": dict(build.LAUNCHES)}
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    del out
    return res


def cells(archs=None):
    for name in sorted(archs or ARCHS):
        for shape in applicable_shapes(ARCHS[name]):
            yield name, shape.name


def _value(v: str):
    if v in ("True", "False"):
        return v == "True"
    if v.isdigit():
        return int(v)
    return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-collectives", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override key=value (perf variants)")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model (or pod,data,model) in place of the "
                    "production mesh")
    ap.add_argument("--real-rank", action="store_true",
                    help="run the cell with real tensors as rank 0 (on "
                    "the card; --cpu on the CPU)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _value(v)
    ms = (tuple(int(x) for x in args.mesh_shape.split(","))
          if args.mesh_shape else None)
    device = "meta"
    if args.real_rank:
        from .. import devices

        device = devices.resolve("cpu" if args.cpu else None)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if ms is not None:
        meshes = [len(ms) == 3]
    if args.all:
        todo = [(a, s, mp) for a, s in cells() for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    results = []
    for arch, shape, mp in todo:
        mesh = ("x".join(map(str, ms)) if ms
                else "2x16x16" if mp else "16x16")
        print(f"[dryrun] {arch} × {shape} × {mesh} ...", flush=True)
        try:
            rec = run_cell(arch, shape, mp, overrides=overrides or None,
                           mesh_shape=ms, device=device,
                           collectives=not args.no_collectives)
            rec["overrides"] = overrides
            rec["ok"] = True
            coll = rec.get("collectives", {}).get("total", 0)
            print(f"[dryrun]   ok trace={rec['trace_s']}s "
                  f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                  f"coll={coll:.3e} args={rec['argument_size_in_bytes']:.3e} "
                  f"temp={rec['temp_size_in_bytes']:.3e} "
                  f"kernel_calls={rec['kernel_calls']}"
                  + (f" extrapolated={rec['extrapolated']}"
                     if "extrapolated" in rec else "")
                  + (f" real_rank={rec['real_rank']}"
                     if "real_rank" in rec else ""), flush=True)
        # tracecheck: allow-broad-except(sweep driver: one failing cell is recorded with its traceback, the rest still run)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun]   FAIL {type(e).__name__}: {e}", flush=True)
        results.append(rec)

    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells traced")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    if n_ok != len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
