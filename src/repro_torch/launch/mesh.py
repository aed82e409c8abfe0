"""Device meshes over ``torch.distributed``, the collectives the model
runs on them, and the layout of a parameter tree over a mesh.

Counterpart of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the axes ``("data",
"model")``; each process is one rank of it, and the mesh needs the
process group to be initialised first
(``torch.distributed.init_process_group``, given its address, world size
and rank).  A collective over one axis runs on ``mesh.get_group(axis)``.

Layouts.  A spec is a tuple with one entry a dim: the mesh axis the dim
is split over, or None (the JAX package's ``PartitionSpec``).  A rank
holds its block of each split dim (:func:`block`);
:func:`shard_params` lays a whole parameter tree out by its specs and
:func:`gather_params` gathers it back.

Collectives under autograd.  The model keeps one rule: a tensor that is
whole on every rank of ``"model"`` carries the whole gradient on each of
them (the ranks of ``"model"`` compute the same loss), while the ranks of
``"data"`` see different tokens and each holds its part of the gradient.
So:

* :func:`all_gather` joins blocks; its backward either sums the
  gradient over the axis and keeps the rank's block (``grad="sum"``: a
  weight's FSDP gather over ``"data"``, a reduce-scatter) or keeps the
  rank's block alone (``grad="block"``: whoever reads the whole tensor
  reads it on every rank alike).
* :func:`split` takes the rank's block of a whole tensor; its backward
  gathers the blocks' gradients (Megatron's sequence-parallel scatter).
* :func:`all_reduce` sums partial results, identity backward, and
  :func:`all_reduce_grad` is the identity whose backward sums: the two
  operators Megatron puts after a row-parallel product and before a
  column-parallel one (``torch.distributed.nn.functional.all_reduce``
  would sum the gradient again in its backward, ``m`` times too large
  where every rank holds it already).
* :func:`all_to_all` exchanges equal blocks of dim 0; it is its own
  inverse, so its backward is the same exchange.
* :func:`reduce_scatter` sums partial results and keeps the rank's
  block; its backward gathers the blocks' gradients (each rank's partial
  fed every block).

Axes.  An axis is a mesh dim's name or a tuple of names, split over the
product of their sizes in row-major order (the JAX package's
``("pod", "data")`` entries).  On a mesh with a ``"pod"`` axis,
``"data"`` names the product ``("pod", "data")``: the axes the batch and
the weights' FSDP blocks split over (the JAX package's ``podify_specs``
and ``batch_axes``), so the model's specs and code read the same on the
(16, 16) and the (2, 16, 16) mesh.

Every collective adds the bytes this rank hands it to
:func:`collective_bytes` (by operation; forward and backward alike), the
count a test reads to see what one decode step moves.  A collective
failure is never caught.

One function of the JAX module has no counterpart here:
``activate_mesh``: torch has no ambient mesh.  The code that distributes
takes the mesh as an argument, as the JAX package's ``apply_moe(...,
mesh=)`` and the model entry points already take it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.tree import tree_flatten, tree_unflatten

AXES = ("data", "model")
_BYTES: dict = {}


def make_mesh(shape, axes=AXES, device_type: str = "cuda"):
    """A mesh of ``shape`` over every rank of the initialised process
    group (``prod(shape)`` must be its world size), with rank ``r`` at
    row-major position ``r``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device_type: str = "cuda"):
    """The (1, 1) mesh with the production axis names, for a world of
    one process."""
    return make_mesh((1, 1), AXES, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The JAX package's production layouts: (16, 16) over ``("data",
    "model")``, or (2, 16, 16) over ``("pod", "data", "model")``, over a
    process group of 256 or 512 ranks (a layout, not a claim about the
    hardware under it; ``launch/dryrun.py`` builds it over a ``"fake"``
    group in one process)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), AXES, device_type)


def _names(mesh, axis) -> tuple:
    """The mesh dims ``axis`` spans, in mesh order: a name or a tuple of
    names (dims the mesh lacks dropped); ``"data"`` also spans ``"pod"``
    where the mesh has one."""
    have = tuple(mesh.mesh_dim_names or ())
    want = (axis,) if isinstance(axis, str) else tuple(axis)
    if "data" in want and "pod" in have:
        want = want + ("pod",)
    return tuple(a for a in have if a in want)


def axis_size(mesh, axis) -> int:
    """The size of ``axis`` (1 for an axis the mesh does not have)."""
    have = tuple(mesh.mesh_dim_names or ())
    return math.prod(mesh.shape[have.index(a)] for a in _names(mesh, axis))


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along ``axis`` (row-major over a
    product)."""
    have = tuple(mesh.mesh_dim_names or ())
    idx = 0
    for a in _names(mesh, axis):
        n = mesh.shape[have.index(a)]
        idx = idx * n + (mesh.get_local_rank(a) if n > 1 else 0)
    return idx


def group(mesh, axis):
    """The process group of ``axis``: a mesh dim's own, or one over the
    product of several (made once a mesh, in rank order)."""
    names = _names(mesh, axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if names not in cache:
        cache[names] = mesh[names]._flatten("_".join(names)).get_group()
    return cache[names]


def batch_axes(mesh) -> tuple:
    """The mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data")
                 if a in tuple(mesh.mesh_dim_names or ()))


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape)


def is_spec(node) -> bool:
    """A spec tree's leaves are tuples (the trees hold no other tuple)."""
    return isinstance(node, tuple)


# ---------------------------------------------------------------------------
# collectives (every one counted in collective_bytes)


def collective_bytes() -> dict:
    """{operation: bytes this rank handed to it} since the last reset."""
    return dict(_BYTES)


def reset_collective_bytes() -> None:
    _BYTES.clear()


def _count(op: str, t: torch.Tensor) -> None:
    _BYTES[op] = _BYTES.get(op, 0) + t.numel() * t.element_size()


def block(t, mesh, axis, dim: int):
    """This rank's block of ``t`` along ``dim``, split over ``axis``."""
    size = axis_size(mesh, axis)
    if size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over the {size} ranks of axis {axis!r}")
    n = t.shape[dim] // size
    return t.narrow(dim, axis_index(mesh, axis) * n, n)


def _gather(t, mesh, axis, dim: int):
    t = t.contiguous()
    _count("all_gather", t)
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _sum(t, mesh, axis, op: str = "all_reduce"):
    t = t.clone(memory_format=torch.contiguous_format)
    _count(op, t)
    dist.all_reduce(t, group=group(mesh, axis))
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, grad):
        ctx.args = (mesh, axis, dim, grad)
        return _gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim, grad = ctx.args
        if grad == "sum":
            dy = _sum(dy, mesh, axis)
        # a copy: a view of the block would keep the whole gradient alive
        return block(dy, mesh, axis, dim).clone(), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return block(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim = ctx.args
        return _gather(dy, mesh, axis, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        # a sum then the rank's block: gloo has no reduce-scatter on
        # every release; counted as the reduce-scatter it stands for
        return block(_sum(t, mesh, axis, "reduce_scatter"), mesh, axis,
                     dim).clone()

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim = ctx.args
        return _gather(dy, mesh, axis, dim), None, None, None


def _exchange(t, mesh, axis):
    t = t.contiguous()
    _count("all_to_all", t)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group(mesh, axis))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return _exchange(t, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, *ctx.args), None, None


def all_gather(t, mesh, axis, dim: int, grad: str = "block"):
    """The blocks of ``t`` over ``axis`` joined along ``dim``.  Backward:
    ``grad="block"`` keeps the rank's block of the gradient, ``"sum"``
    sums it over the axis first (a reduce-scatter)."""
    if axis_size(mesh, axis) == 1:
        return t
    return _AllGather.apply(t, mesh, axis, dim, grad)


def split(t, mesh, axis, dim: int):
    """This rank's block of a whole ``t``; backward gathers the blocks'
    gradients."""
    if axis_size(mesh, axis) == 1:
        return t
    return _Split.apply(t, mesh, axis, dim)


def all_reduce(t, mesh, axis):
    """The sum of ``t`` over ``axis``, a new tensor; identity backward."""
    if axis_size(mesh, axis) == 1:
        return t
    return _AllReduce.apply(t, mesh, axis)


def all_reduce_grad(t, mesh, axis):
    """``t`` itself; backward sums the gradient over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return t
    return _AllReduceGrad.apply(t, mesh, axis)


def all_to_all(t, mesh, axis):
    """Rank ``r``'s ``j``-th block of dim 0 goes to rank ``j``, into its
    ``r``-th block (``all_to_all_single``); backward the same."""
    if axis_size(mesh, axis) == 1:
        return t
    return _AllToAll.apply(t, mesh, axis)


def reduce_scatter(t, mesh, axis, dim: int):
    """The rank's block along ``dim`` of the sum of ``t`` over ``axis``;
    backward gathers the blocks' gradients."""
    if axis_size(mesh, axis) == 1:
        return t
    return _ReduceScatter.apply(t, mesh, axis, dim)


def reshard(t, mesh, src: tuple, dst: tuple):
    """An activation from layout ``src`` to ``dst``: gather each dim split
    in ``src`` but not in ``dst`` (backward: the rank's block), then split
    each dim split in ``dst`` but not in ``src`` (backward: gather).  Every
    gather comes before any split: a dim split first would mix other
    ranks' blocks into a later gather over the same axis (``ep_psum``'s
    output, its features over ``"data"``, back to rows over ``"data"``)."""
    moved = [(dim, a, b) for dim, (a, b) in enumerate(zip(src, dst))
             if a != b]
    for dim, a, _ in moved:
        if a is not None:
            t = all_gather(t, mesh, a, dim)
    for dim, _, b in moved:
        if b is not None:
            t = split(t, mesh, b, dim)
    return t


def gather_param(t, mesh, spec: tuple, keep: tuple | None = None):
    """A parameter block gathered over every axis of ``spec`` that
    ``keep`` (default: none) does not keep on the same dim.  Its
    gradient is summed over the batch axes, whose ranks saw different
    tokens, and only blocked over ``"model"``, whose ranks computed the
    same thing."""
    keep = keep or (None,) * len(spec)
    for dim, (a, b) in enumerate(zip(spec, keep)):
        if a is not None and a != b:
            grad = "sum" if is_batch_axis(a) else "block"
            t = all_gather(t, mesh, a, dim, grad)
    return t


def is_batch_axis(axis) -> bool:
    """Whether ``axis`` (a name or a tuple) is one the batch splits over,
    whose ranks see other tokens."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return all(a in ("pod", "data") for a in names)


def gather_tree(params, specs, mesh):
    """``params`` (this rank's blocks) gathered whole by ``specs``, under
    :func:`gather_param`'s gradients."""
    return tree_unflatten(params, [
        gather_param(v, mesh, spec) for v, spec in
        zip(tree_flatten(params).values(), leaf_specs(params, specs))])


# ---------------------------------------------------------------------------
# a parameter tree at rest


def shard_params(params, specs, mesh):
    """This rank's at-rest blocks of whole ``params`` under ``specs`` (a
    tree of the same structure whose leaves are specs).  Each block is a
    copy, so the whole tensors can be freed.  A dim that does not split
    over its axis raises, naming the leaf."""
    flat = tree_flatten(specs, is_leaf=is_spec)
    out = []
    for path, leaf in tree_flatten(params).items():
        spec = flat[path]
        if len(spec) != leaf.dim():
            raise ValueError(f"{path}: spec {spec} for a {leaf.dim()}-d "
                             "leaf")
        for dim, axis in enumerate(spec):
            if axis is not None and leaf.shape[dim] % axis_size(mesh, axis):
                raise ValueError(
                    f"{path}: dim {dim} of {tuple(leaf.shape)} does not "
                    f"split over the {axis_size(mesh, axis)} ranks of axis "
                    f"{axis!r}")
        for dim, axis in enumerate(spec):
            if axis is not None:
                leaf = block(leaf, mesh, axis, dim)
        out.append(leaf.clone())
    return tree_unflatten(params, out)


def gather_params(params, specs, mesh):
    """The whole tree back from every rank's :func:`shard_params`
    blocks (no gradient)."""
    with torch.no_grad():
        return gather_tree(params, specs, mesh)


def leaf_specs(params, specs) -> list:
    """The spec of each leaf of ``params``, in ``tree_leaves`` order."""
    flat = tree_flatten(specs, is_leaf=is_spec)
    return [flat[path] for path in tree_flatten(params)]
