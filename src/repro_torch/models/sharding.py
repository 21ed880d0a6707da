"""Logical-axis sharding on a torch ``DeviceMesh`` — the reference's
``repro.models.sharding`` (MaxText-style rules), for the port.

Model code names the logical axes of its tensors; a launcher installs a
:class:`MeshRules` mapping logical names to mesh dims for one (arch ×
shape × mesh) cell.  With no rules installed, and on plain tensors,
every helper here is a no-op, so the single-device path runs unchanged.

A *spec* is the reference's ``PartitionSpec`` as a tuple: per tensor dim
None, a mesh dim name, or a tuple of names (the dim split over both, the
first name outermost).  :class:`NamedSharding` pairs a spec with a mesh
and gives its DTensor placements, one per mesh dim.

How the port computes on a mesh (the reference leaves it to XLA's SPMD
partitioner).  Every rank runs the model on local tensors:

* the ``batch`` rule's mesh dims (``pod``, ``data``) partition compute:
  each rank holds its rows of the batch, and the loss is the mean over
  the global batch;
* parameters, optimizer moments, error-feedback buffers and decode
  caches are DTensors sharded by the rules, so every mesh dim partitions
  storage; a layer gathers its parameters whole when it runs
  (:func:`gathered`, under remat again in the backward) and drops them
  after, and a gathered parameter's gradient is reduce-scattered back to
  its shard;
* ``model`` partitions compute only in the expert-parallel MoE
  (``layers.moe_block_ep``): tokens split over the token axes, experts
  over ``model``, two ``all_to_all`` exchanges.  Elsewhere the ranks
  along ``model`` compute the same activations, and the backward of
  every exchange that crosses them is written so that their gradients
  are not summed M times.

A CUDA graph captures a train step through these helpers
(``launch.train.TrainGraph``): each issues the same collectives, in the
same order, on every rank, reads no tensor on the host and allocates
only what the inputs' shapes fix (equal chunks; a mesh dim of size 1
issues nothing, as DTensor skips it too).  The CPU tests of
``test_torch_mesh_graph.py`` hold the step to that on gloo ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: list = []


def axis_sizes(mesh) -> dict:
    """Mesh dim name → size, for a torch ``DeviceMesh`` or any object
    with a ``shape`` dict (a stand-in mesh, as the tests use)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.shape)


def mesh_dims(entry) -> tuple:
    """A spec entry's mesh dim names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def coordinate(mesh, names: tuple) -> tuple:
    """``(index, count)`` of this rank along the mesh dims ``names``
    taken together, the first outermost: where its rows sit among the
    ``count`` equal shares they split."""
    sizes, index, count = axis_sizes(mesh), 0, 1
    for a in names:
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return index, count


def sharded_batch_dims(rules) -> tuple:
    """The batch dims of ``rules`` with more than one rank on a torch
    mesh: where this rank holds only its rows.  Empty with no rules or a
    stand-in mesh."""
    if rules is None or not hasattr(rules.mesh, "get_group"):
        return ()
    sizes = axis_sizes(rules.mesh)
    return tuple(a for a in rules.batch_axes() if sizes[a] > 1)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (none exists before the module that
    defines them is imported, so a plain run never imports it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor
        dim ``d`` takes the mesh dim, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for name in mesh_dims(entry):
                out[names.index(name)] = Shard(d)
        return tuple(out)


class MeshRules:
    """Mapping of logical axis name → mesh dim (or tuple, or None).

    ``act_overrides`` is a per-cell patch applied by :meth:`act` — the
    activation / cache view of the rules (parameters' FSDP ``embed`` →
    data rule must not bind activations; decode cells shard the cache's
    sequence on the mesh dim that parameters use for kv_heads)."""

    def __init__(self, mesh, rules: dict, act_overrides: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(rules)
        self.act_overrides = {"embed": None, **(act_overrides or {})}

    def axis_size(self, rule) -> int:
        """Product of the mesh dim sizes a rule entry maps to."""
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in mesh_dims(rule):
            n *= sizes[a]
        return n

    def spec_for_shape(self, axes: tuple, shape: tuple) -> tuple:
        """Spec with non-dividing entries degraded: a tuple rule falls
        back to its longest dividing prefix, a scalar rule to None (a
        504-way vocab on a 16-way model dim stays replicated)."""
        out = []
        for a, d in zip(axes, shape):
            r = self.rules.get(a) if a is not None else None
            if r is not None:
                cand = mesh_dims(r)
                while cand and d % self.axis_size(cand) != 0:
                    cand = cand[:-1]
                r = cand if len(cand) > 1 else (cand[0] if cand else None)
            out.append(r)
        return tuple(out)

    def sharding_for_shape(self, axes: tuple, shape: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for_shape(axes, shape))

    def act(self) -> "MeshRules":
        r = dict(self.rules)
        r.update(self.act_overrides)
        return MeshRules(self.mesh, r, {})

    def batch_axes(self) -> tuple:
        """The mesh dims the ``batch`` rule names: where the ranks hold
        different rows and so compute different activations."""
        return mesh_dims(self.rules.get("batch"))


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    if rules is None:
        yield
        return
    _ACTIVE.append(rules)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_rules() -> Optional[MeshRules]:
    return _ACTIVE[-1] if _ACTIVE else None


def logical(x, *axes):
    """Constrain ``x`` to the sharding its logical ``axes`` imply.

    A no-op with no rules installed, when the rank does not match, or on
    a plain tensor — the port's activations are each rank's local
    tensors (its batch rows), whose layout the rules already fixed.  A
    DTensor is redistributed to the placements of
    :meth:`MeshRules.spec_for_shape`."""
    r = current_rules()
    if r is None or x.ndim != len(axes) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          r.sharding_for_shape(axes, x.shape).placements)


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------

def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements``: mesh dims in
    order, each ``Shard(d)`` taking the rank's equal chunk of dim ``d`` of
    what the earlier ones left (a tensor dim over two mesh dims splits by
    the first, then each piece by the second, as DTensor nests them)."""
    from torch.distributed.tensor import Shard

    out = full
    for name, p in zip(axis_names(mesh), placements):
        if isinstance(p, Shard):
            n = mesh.size(axis_names(mesh).index(name))
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split {n} ways over {name!r}")
            out = out.chunk(n, p.dim)[mesh.get_local_rank(name)]
    return out


def distribute(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``full`` (the same values on every rank) as a DTensor of
    ``sharding``: each rank keeps a copy of its shard only."""
    from torch.distributed.tensor import DTensor

    mesh, pl = sharding.mesh, sharding.placements
    local = local_chunk(full, mesh, pl).contiguous().clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def local(x) -> torch.Tensor:
    """A DTensor's local shard (its storage, so an in-place write lands
    in the DTensor), or a plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def full(x) -> torch.Tensor:
    """The whole value of a DTensor on every rank (a collective), or a
    plain tensor itself."""
    return x.full_tensor() if is_dtensor(x) else x


def gathered(tree, differ: Optional[tuple] = None, keep: tuple = ()):
    """Each DTensor leaf of ``tree`` whole on every rank, as a local
    tensor in the autograd graph (plain leaves as they are).

    ``keep``: mesh dims whose placement stays (the expert-parallel MoE
    keeps its experts sharded over ``model``).  ``differ``: mesh dims
    along which the ranks compute different activations from the
    gathered value (default: the current rules' batch dims); the
    gradient is summed over those (``Partial``) and taken as identical
    over the others (``Replicate``, so never summed M times), then
    reduced back to the leaf's shard."""
    if isinstance(tree, dict):
        return {k: gathered(v, differ, keep) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Partial, Replicate

    if differ is None:
        r = current_rules()
        differ = r.batch_axes() if r is not None else ()
    names = axis_names(tree.device_mesh)
    target, grad = [], []
    for name, p in zip(names, tree.placements):
        if name in keep:
            target.append(p)
            grad.append(p)
        else:
            target.append(Replicate())
            grad.append(Partial() if name in differ else Replicate())
    return tree.redistribute(tree.device_mesh, target).to_local(
        grad_placements=grad)


def _split(x, dims: tuple) -> tuple:
    """DTensor ``x``'s placements split at ``dims``: ``(those over dims
    kept and the rest replicated, the reverse)``."""
    from torch.distributed.tensor import Replicate

    names = axis_names(x.device_mesh)
    inside = [p if n in dims else Replicate() for n, p in zip(names,
                                                             x.placements)]
    outside = [Replicate() if n in dims else p for n, p in zip(names,
                                                              x.placements)]
    return inside, outside


@contextlib.contextmanager
def local_cache(tree: Optional[dict]):
    """A layer's decode cache as local tensors the block may write in
    place: a plain leaf as it is; a DTensor leaf gathered over every mesh
    dim but the batch's (this rank's rows, their whole sequence), and on
    exit this rank's shard of what the block wrote copied back into the
    DTensor's storage."""
    if tree is None or not any(is_dtensor(v) for v in tree.values()):
        yield tree
        return
    r = current_rules()
    batch = r.batch_axes() if r is not None else ()
    whole = {k: v.redistribute(v.device_mesh, _split(v, batch)[0]).to_local()
             if is_dtensor(v) else v for k, v in tree.items()}
    yield whole
    for k, v in tree.items():
        if is_dtensor(v):
            v.to_local().copy_(local_chunk(whole[k], v.device_mesh,
                                           _split(v, batch)[1]))


# ---------------------------------------------------------------------------
# collectives with a gradient
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks of dim 0; its backward is the
    same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.grp)
        return out, None


class _SplitRows(torch.autograd.Function):
    """Forward: this rank's equal chunk of dim 0 of a tensor every rank
    of the group holds whole.  Backward: the chunks' gradients gathered,
    so every rank gets the whole (identical) gradient."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        n, r = dist.get_world_size(grp), dist.get_rank(grp)
        return x.chunk(n, 0)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_rows(g, ctx.grp), None


class _GatherRows(torch.autograd.Function):
    """Forward: the group's chunks concatenated along dim 0, for compute
    every rank of the group then repeats alike.  Backward: this rank's
    chunk of the (identical) gradient, not a sum over the group."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _all_gather_rows(x, grp)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.grp), dist.get_rank(ctx.grp)
        return g.chunk(n, 0)[r].contiguous(), None


class _GatherRowsSum(torch.autograd.Function):
    """Forward: the group's chunks concatenated along dim 0, for compute
    whose gradient each rank holds only in part.  Backward: the partial
    gradients summed over the group, this rank's chunk kept."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _all_gather_rows(x, grp)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.grp)
        n, r = dist.get_world_size(ctx.grp), dist.get_rank(ctx.grp)
        return g.chunk(n, 0)[r].contiguous(), None


class _SumForward(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the gradient as it is —
    each rank's summand reaches the replicated result once, through this
    rank's own copy of the objective."""

    @staticmethod
    def forward(ctx, x, grp):
        out = x.clone()
        dist.all_reduce(out, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather_rows(x, grp):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, x, group=grp)
    return torch.cat(parts, 0)


def _groups(mesh, names, outer_first: bool):
    """Groups of ``names`` with more than one rank; for row gathers the
    innermost dim first, so rows end up outer-major."""
    sizes = axis_sizes(mesh)
    names = [n for n in names if sizes[n] > 1]
    return [mesh.get_group(n) for n in (names if outer_first
                                        else reversed(names))]


def all_to_all(x, mesh, name: str):
    grp = _groups(mesh, (name,), True)
    return _AllToAll.apply(x, grp[0]) if grp else x


def split_rows(x, mesh, names: tuple):
    """This rank's rows of ``x`` over ``names`` (outer dim first), from a
    tensor every rank holds whole."""
    for grp in _groups(mesh, names, True):
        x = _SplitRows.apply(x, grp)
    return x


def gather_rows(x, mesh, names: tuple, partial_grad: bool = False):
    """Rows of every rank over ``names`` concatenated (outer dim major).
    ``partial_grad``: the gradient each rank gets back is partial (sum it
    over the group) rather than the same on every rank."""
    fn = _GatherRowsSum if partial_grad else _GatherRows
    for grp in _groups(mesh, names, False):
        x = fn.apply(x, grp)
    return x


def sum_over(x, mesh, names: tuple):
    """The sum of ``x`` over the ranks of ``names``; the gradient passes
    to each rank's summand unchanged (see :class:`_SumForward`)."""
    for grp in _groups(mesh, names, True):
        x = _SumForward.apply(x, grp)
    return x


def reduce_(x, mesh, names: tuple, op=None):
    """In-place all-reduce of ``x`` over ``names`` (no gradient)."""
    op = dist.ReduceOp.SUM if op is None else op
    for grp in _groups(mesh, names, True):
        dist.all_reduce(x, op=op, group=grp)
    return x
