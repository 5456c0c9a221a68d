"""Collectives over the mesh's 'model' axis with the right gradients
(Megatron's f and g), and the tensor-parallel context the forwards read.

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
sum part of a product or keep a slice of the logits.  The context also
records the mesh's 'data' size (``data_size``), so that a module that
does not split its rows over 'data' (the serving pool) can refuse such
a mesh rather than repeat the whole pool on every data rank.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch


class _Model(NamedTuple):
    group: object
    rank: int
    size: int


_MODEL: Optional[_Model] = None
_DATA: int = 1


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the forwards inside with the mesh's 'model' axis split (a
    no-op for ``None`` or one model rank, but for ``data_size``).  A
    mesh may also be a one-axis slice, ``mesh["model"]``."""
    global _MODEL, _DATA
    prev = _MODEL, _DATA
    sizes = ({} if mesh is None
             else dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))))
    if sizes.get("model", 1) > 1:
        _MODEL = _Model(mesh.get_group("model"),
                        mesh.get_local_rank("model"), sizes["model"])
    else:
        _MODEL = None
    _DATA = sizes.get("data", 1)
    try:
        yield
    finally:
        _MODEL, _DATA = prev


def model_size() -> int:
    return 1 if _MODEL is None else _MODEL.size


def data_size() -> int:
    """The 'data' size of the mesh of the active context (1 outside)."""
    return _DATA


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


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(_MODEL.size)]
    dist.all_gather(parts, x.contiguous(), group=_MODEL.group)
    return torch.cat(parts, dim=dim)


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
