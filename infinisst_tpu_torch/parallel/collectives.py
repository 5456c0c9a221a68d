"""Collectives over the mesh's 'model' axis with the right gradients
(Megatron's f and g), the 'data' axis's gathers and row helpers, and
the context the forwards and decoders read.

GSPMD places the JAX package's collectives; here they are written where
the forwards split a product over 'model':

- ``copy_to_model`` (f): the identity forward, a sum over 'model'
  backward.  Before a column-parallel product: its input is replicated,
  and each rank's slice of the product gives part of the input's
  gradient.
- ``reduce_from_model`` (g): a sum over 'model' forward, the identity
  backward.  After a row-parallel product.  (Not
  ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
  gradient again: every rank computes the same loss after g, so that
  would scale the gradients by n_model.)
- ``gather_from_model``: an all-gather along a dim, whose backward keeps
  this rank's slice (a column-parallel product whose output joins the
  replicated stream).
- ``split_to_model``: this rank's slice of a replicated tensor, whose
  backward all-gathers (the input of a row-parallel product that is not
  already split).

The context (``tensor_parallel(mesh)``) is process-wide: one process a
rank, SPMD.  Outside it, or with one model rank, every function here is
the identity and the forwards run exactly as on one card.  The forwards
hold the widths they read from the leaves' shapes to it
(``split_width``): parameters split over 'model' outside the context,
whole ones inside it, or a context of another size raise rather than
sum part of a product or keep a slice of the logits.

The 'data' axis, as the JAX package's ``zero`` has it (FSDP):

- ``shard_params`` marks each leaf it splits over 'data' with the dim
  (``mark_data_shard``; ``data_dim`` reads it back).  A forward gathers
  a marked leaf where it uses it (``unshard``; a layer at the layer
  slicing, ``layer_slice``, inside the checkpointed function under
  remat): an all-gather forward, a reduce-scatter backward, which is
  the FSDP gradient, summed over the data ranks and left on this
  rank's shard.  A leaf that takes no gradient has no backward.
- Inside the context the rows a forward or a decoder sees are this
  data rank's block of the whole batch (the sharded step's rows, a
  serving pool's rows): ``rows_of`` cuts that block out of a
  whole-batch tensor, ``gather_rows`` joins every rank's block (a
  device collective, which a captured piece can hold),
  ``any_over_data`` makes a host decision the same on every data rank
  (a loop runs while any row of the whole batch is live;
  ``any_over_data_tensor`` is its device form, for a piece) and
  ``pool_rand`` draws the whole batch's uniforms and keeps this rank's
  rows, so that a split pool draws the one-rank pool's numbers.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch


class _Axis(NamedTuple):
    group: object
    rank: int
    size: int


_MODEL: Optional[_Axis] = None
_DATA: Optional[_Axis] = None


def _axis(mesh, sizes, name) -> Optional[_Axis]:
    if sizes.get(name, 1) <= 1:
        return None
    return _Axis(mesh.get_group(name), mesh.get_local_rank(name),
                 sizes[name])


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the forwards and decoders inside on the mesh: its 'model' axis
    splits the products, its 'data' axis the rows and the marked leaves
    (a no-op for ``None`` or a mesh of one rank).  A mesh may also be a
    one-axis slice, ``mesh["model"]``."""
    global _MODEL, _DATA
    prev = _MODEL, _DATA
    sizes = ({} if mesh is None
             else dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))))
    _MODEL = _axis(mesh, sizes, "model")
    _DATA = _axis(mesh, sizes, "data")
    try:
        yield
    finally:
        _MODEL, _DATA = prev


def model_size() -> int:
    return 1 if _MODEL is None else _MODEL.size


def data_size() -> int:
    """The 'data' size of the mesh of the active context (1 outside)."""
    return 1 if _DATA is None else _DATA.size


def data_rank() -> int:
    return 0 if _DATA is None else _DATA.rank


def split_width(local: int, whole: int, what: str) -> int:
    """``local``, the part of ``whole`` (heads, columns) that this rank's
    leaves hold, read from their shapes, held to the active context:
    ``whole`` on one card, ``whole / n`` under ``tensor_parallel`` over n
    model ranks.  Raises otherwise (leaves from ``shard_params`` used
    outside the context, or on another mesh)."""
    n = model_size()
    if local * n != whole:
        raise RuntimeError(
            f"{what}: the leaves hold {local} of {whole} on this rank, but "
            f"{n} 'model' rank(s) are active; run parameters split by "
            "shard_params inside tensor_parallel(mesh), on the mesh they "
            "were split over")
    return local


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, group=_MODEL.group)
    return y


def _all_gather(x: torch.Tensor, dim: int, axis=None) -> torch.Tensor:
    import torch.distributed as dist

    axis = axis or _MODEL
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks, this rank's chunk along
    ``dim``."""
    import torch.distributed as dist

    parts = list(x.movedim(dim, 0).contiguous().chunk(axis.size))
    out = torch.empty_like(parts[axis.rank])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.chunk(_MODEL.size, dim)[_MODEL.rank].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _slice(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim), None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.axis), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f: identity forward, sum over 'model' backward."""
    return x if _MODEL is None else _Copy.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g: sum over 'model' forward, identity backward."""
    return x if _MODEL is None else _Reduce.apply(x)


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` over 'model'; backward keeps the slice."""
    return x if _MODEL is None else _Gather.apply(x, dim % x.ndim)


def split_to_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's slice along ``dim``; backward all-gathers."""
    return x if _MODEL is None else _Split.apply(x, dim % x.ndim)


def head_logits(h: torch.Tensor, head, vocab: int, mm) -> torch.Tensor:
    """``mm(h, head)`` for an lm_head in any of its tensor-parallel
    layouts, read from its local shape: whole (D, V), split on the
    vocabulary (D, V/n: column-parallel, gathered along V) or, where the
    vocabulary divides by no axis and ``sanitize_spec`` moved 'model'
    onto D, split on D (D/n, V: row-parallel, summed over 'model')."""
    if isinstance(head, dict):
        return mm(h, head)
    rows, cols = head.shape[-2], head.shape[-1]
    if _MODEL is None:
        if rows != h.shape[-1] or cols < vocab:
            raise RuntimeError(
                f"an lm_head of {rows} x {cols} for {h.shape[-1]} x {vocab} "
                "outside tensor_parallel: run parameters split by "
                "shard_params inside tensor_parallel(mesh)")
        return mm(h, head)
    if rows != h.shape[-1]:
        return reduce_from_model(mm(split_to_model(h, -1), head))
    if cols < vocab:
        return gather_from_model(mm(copy_to_model(h), head), -1)
    return mm(h, head)


# -- the 'data' axis: FSDP leaves -------------------------------------------

_SHARD_ATTR = "_data_shard_dim"


def mark_data_shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Mark ``t`` as this rank's shard of a leaf split over 'data' along
    ``dim`` (``shard_params`` does); returns ``t``."""
    setattr(t, _SHARD_ATTR, dim)
    return t


def data_dim(t) -> Optional[int]:
    """The dim over which ``t`` is a 'data' shard, or None (whole)."""
    return getattr(t, _SHARD_ATTR, None)


def unshard(t):
    """A marked leaf gathered whole over 'data' (an all-gather, whose
    backward reduce-scatters the gradient onto the shard); anything else
    as it is.  Outside a context with 'data' above 1 a marked leaf
    raises: it holds part of its dim."""
    d = data_dim(t) if torch.is_tensor(t) else None
    if d is None:
        return t
    if _DATA is None:
        raise RuntimeError(
            f"a parameter split over 'data' (dim {d} of shape "
            f"{tuple(t.shape)}) outside tensor_parallel(mesh): run "
            "parameters split by shard_params inside the context of the "
            "mesh they were split over")
    return _GatherData.apply(t, d, _DATA)


def unshard_tree(tree):
    """``unshard`` over a dict / list tree of leaves."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unshard_tree(v) for v in tree)
    return unshard(tree)


def layer_slice(v, i):
    """Layer ``i`` (an int: one layer; a slice: a sub-stack) of a stacked
    leaf, a 'data' shard marked as such when ``v`` is one, for
    ``unshard`` where the layer is used."""
    s = v[i]
    d = data_dim(v) if torch.is_tensor(v) else None
    if d is not None:
        if d == 0:
            raise ValueError(
                "a stacked leaf split over 'data' on its layer dim: "
                "gathering one layer of it is not ported")
        mark_data_shard(s, d - 1 if isinstance(i, int) else d)
    return s


# -- the 'data' axis: rows --------------------------------------------------

def rows_of(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This data rank's block of a whole-batch tensor along ``dim``."""
    if _DATA is None:
        return x
    return x.chunk(_DATA.size, dim)[_DATA.rank]


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's block of rows joined along ``dim`` (the whole
    batch, on every rank)."""
    if _DATA is None:
        return x
    return _all_gather(x, dim, _DATA)


def any_over_data(flag: bool) -> bool:
    """``flag`` or'ed over the data ranks: a host decision every rank of
    a split batch takes alike (a collective: every rank calls it)."""
    if _DATA is None:
        return bool(flag)
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend(_DATA.group) == "nccl" else "cpu"
    t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_DATA.group)
    return bool(t.item())


def any_over_data_tensor(flag: torch.Tensor) -> torch.Tensor:
    """``any_over_data`` without a host read: a () bool tensor or'ed over
    the data ranks on the device, which a CUDA graph can hold (an NCCL
    all-reduce inside the capture; gloo runs it as it is)."""
    if _DATA is None:
        return flag
    import torch.distributed as dist

    t = flag.to(torch.int64).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_DATA.group)
    return t[0] > 0


def pool_rand(shape, generator, device, dim: int = 0) -> torch.Tensor:
    """``torch.rand`` of the whole batch (``shape``'s dim ``dim`` times
    the data ranks) from ``generator``, this rank's block of it: every
    data rank draws the same numbers and keeps its own rows."""
    shape = list(shape)
    shape[dim] *= data_size()
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return rows_of(u, dim)
