"""The (data, model) mesh and the sharding rules; port of
``infinisst_tpu/parallel/mesh.py`` over ``torch.distributed``.

The reference trains with NCCL all-reduce under DeepSpeed ZeRO-2
(train/main.py:170-174, SURVEY.md §5.8).  The mesh has two axes:

- 'data'  -- the batch is split over it; with ``zero`` the gradients and
  the optimizer state of a leaf are split along the dim its sanitised
  spec gives 'data' (ZeRO-2: the parameters stay whole on every data
  rank; the JAX package's further sharding of the parameters themselves
  is not ported, ROADMAP §3);
- 'model' -- tensor parallelism over attention heads and FFN columns.

The spec trees are the JAX package's, with the port's own partition spec
``P`` (a tuple: per dim ``None``, an axis name or a tuple of names).  A
spec is made legal for a leaf's shape by ``sanitize_spec`` (the JAX
rules, over a ``{axis: size}`` mapping, so that it runs with no process
group); ``shard_params`` then keeps this rank's 'model' slice of every
leaf and returns a ``Layout`` per leaf: the dim split over 'model' and
the dim split over 'data'.  Where an axis sits on a dim beside another
(``('data', 'model')``), the port's slice is the contiguous 'model'
chunk, split further over 'data' for the optimizer state.

Every weight is stored (in, out); under tensor parallelism a rank holds
a contiguous block of each column-parallel leaf's output columns (query
heads [r H/n, (r+1) H/n), KV heads likewise, which keeps GQA's pairing)
and the matching rows of each row-parallel leaf.  The forwards read
their local head counts from the leaves' shapes and place the
collectives (``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch

AXES = ("data", "model")


class P(tuple):
    """A partition spec: one entry per dim, ``None``, an axis name or a
    tuple of names (JAX's ``PartitionSpec`` indexing: ``spec[i]``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def init_distributed(device="cuda"):
    """Initialise the default process group for ``device`` from
    ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT): NCCL on ``cuda``, where it selects the card LOCAL_RANK
    and returns it, gloo on ``cpu``.  Nothing is chosen for the caller:
    a ``cuda`` group on a machine with no card raises."""
    import os

    import torch.distributed as dist

    from infinisst_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    return dev


def make_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``DeviceMesh`` of shape (data, model) with ``mesh_dim_names =
    ('data', 'model')`` over an initialised process group whose world
    size is ``data * model`` (rank r at (r // model, r % model))."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(
            f"make_mesh(data={data}, model={model}) needs an initialised "
            f"process group of world size {n}; it has {world}")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """{'data': d, 'model': m} of a DeviceMesh or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


# -- parameter partition specs (the JAX package's rules) ---------------------
# Dense weights are stored (in, out).  Column-parallel layers (qkv,
# gate/up) are split on their output, row-parallel ones (o_proj, down) on
# their input, over 'model'.  ZeRO: the non-TP dim on 'data'.


def _spec(tp_dim: Optional[int], ndim: int, zero: bool,
          zero_dim: Optional[int]) -> P:
    axes: list = [None] * ndim
    if tp_dim is not None:
        axes[tp_dim] = "model"
    if zero and zero_dim is not None and axes[zero_dim] is None:
        axes[zero_dim] = "data"
    return P(*axes)


def llama_param_specs(zero: bool = False) -> Dict[str, Any]:
    """The spec tree of the Llama parameters (stacked layers have a
    leading layer dim, so their dims shift by one)."""
    return {
        "embed": _spec(1, 2, zero, 0),  # (V, D): D on model, V on data
        "layers": {
            "input_ln": _spec(None, 2, zero, 1),
            "post_ln": _spec(None, 2, zero, 1),
            "wq": _spec(2, 3, zero, 1),  # (L, D, H*Dh) out=model
            "wk": _spec(2, 3, zero, 1),
            "wv": _spec(2, 3, zero, 1),
            "wo": _spec(1, 3, zero, 2),  # (L, H*Dh, D) in=model
            "w_gate": _spec(2, 3, zero, 1),
            "w_up": _spec(2, 3, zero, 1),
            "w_down": _spec(1, 3, zero, 2),
        },
        "final_ln": _spec(None, 1, zero, 0),
        "lm_head": _spec(1, 2, zero, 0),  # (D, V) out=model
    }


def w2v2_param_specs(w2v2_cfg, zero: bool = False) -> Dict[str, Any]:
    """The spec tree of ``wav2vec2.init_params(w2v2_cfg)`` (conv bias and
    extractor-mode variants included)."""
    conv = []
    for i, _ in enumerate(w2v2_cfg.conv_layers):
        entry = {"w": _spec(None, 3, zero, 2)}
        if w2v2_cfg.conv_bias:
            entry["b"] = P(None)
        if w2v2_cfg.extractor_mode == "layer_norm":
            entry["ln_scale"] = P(None)
            entry["ln_bias"] = P(None)
        elif i == 0:  # 'default': GroupNorm on layer 0 only
            entry["gn_scale"] = P(None)
            entry["gn_bias"] = P(None)
        conv.append(entry)
    return {
        "conv": conv,
        "post_ln": {"scale": P(None), "bias": P(None)},
        "post_proj": {"w": _spec(1, 2, zero, 0),
                      "b": _spec(None, 1, None, None)},
        "layers": {
            "ln1_scale": _spec(None, 2, zero, 1),
            "ln1_bias": _spec(None, 2, zero, 1),
            "ln2_scale": _spec(None, 2, zero, 1),
            "ln2_bias": _spec(None, 2, zero, 1),
            "wq": _spec(2, 3, zero, 1),
            "wk": _spec(2, 3, zero, 1),
            "wv": _spec(2, 3, zero, 1),
            "wo": _spec(1, 3, zero, 2),
            "bq": _spec(1, 2, None, None),
            "bk": _spec(1, 2, None, None),
            "bv": _spec(1, 2, None, None),
            "bo": _spec(None, 2, zero, 1),
            "fc1_w": _spec(2, 3, zero, 1),
            "fc1_b": _spec(1, 2, None, None),
            "fc2_w": _spec(1, 3, zero, 2),
            "fc2_b": _spec(None, 2, zero, 1),
        },
        "final_ln": {"scale": P(None), "bias": P(None)},
    }


def adapter_param_specs(n_conv: int, zero: bool = False) -> Dict[str, Any]:
    return {
        "conv": [
            {
                "w": _spec(None, 3, zero, 2),
                "ln_scale": P(None),
                "ln_bias": P(None),
            }
            for _ in range(n_conv)
        ],
        "proj": {"w": _spec(1, 2, zero, 0), "b": _spec(0, 1, None, None)},
    }


def model_param_specs(cfg, zero: bool = False) -> Dict[str, Any]:
    """The spec tree of the combined speech-LLM parameters."""
    return {
        "w2v2": w2v2_param_specs(cfg.w2v2, zero),
        "adapter": adapter_param_specs(len(cfg.adapter.conv_layers), zero),
        "llama": llama_param_specs(zero),
    }


def sanitize_spec(shape, spec, mesh) -> P:
    """Make ``spec`` legal for ``shape`` on ``mesh`` (a DeviceMesh or a
    ``{axis: size}`` mapping): every split dim must divide evenly by its
    axes' sizes.  The flagship vocabulary (128263) divides by no axis, so
    the rule trees can put an axis on an indivisible dim.  Per leaf:

    1. axes of size 1 are dropped;
    2. an axis whose size does not divide its dim MIGRATES to the largest
       dim that can absorb it (appended to that dim's axes when the
       combined split still divides: embed (128263, 4096) on data 8,
       P('data', None) -> P(None, 'data'));
    3. an axis with no such dim is dropped (that dim replicates).
    """
    sizes = mesh_shape(mesh)
    dims: list = []
    for i in range(len(shape)):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            dims.append([])
        elif isinstance(entry, (tuple, list)):
            dims.append([a for a in entry if sizes.get(a, 1) > 1])
        else:
            dims.append([entry] if sizes.get(entry, 1) > 1 else [])

    def divisor(axes):
        d = 1
        for a in axes:
            d *= sizes[a]
        return d

    homeless = []
    for i, axes in enumerate(dims):
        while axes and shape[i] % divisor(axes) != 0:
            homeless.append(axes.pop())
    for a in homeless:
        # prefer the largest dim that can absorb the axis
        cands = [
            i for i in range(len(shape))
            if shape[i] % (divisor(dims[i]) * sizes[a]) == 0
        ]
        if cands:
            best = max(cands, key=lambda i: shape[i] // divisor(dims[i]))
            dims[best].append(a)

    def pack(axes):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    return P(*[pack(a) for a in dims])


def _is_spec(x) -> bool:
    return isinstance(x, (P, Layout))


def _map(fn, tree, spec_tree, path=""):
    """``fn(path, leaf, spec)`` over a parameter tree and its spec tree
    (dicts by key, lists in order); a structure that does not match
    raises with the path."""
    if _is_spec(spec_tree):
        if isinstance(tree, (list, tuple)) or (
                isinstance(tree, dict) and not _is_quantized(tree)):
            raise ValueError(
                f"{path or '<root>'}: the spec tree has a leaf where the "
                f"parameters have a {type(tree).__name__}")
        return fn(path, tree, spec_tree)
    if isinstance(spec_tree, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec_tree):
            got = sorted(tree) if isinstance(tree, dict) else repr(tree)
            raise ValueError(f"{path or '<root>'}: keys {got} do not match "
                             f"the spec tree's {sorted(spec_tree)}")
        return {k: _map(fn, tree[k], spec_tree[k], f"{path}{k}/")
                for k in spec_tree}
    if len(tree) != len(spec_tree):
        raise ValueError(f"{path}: {len(tree)} entries, the spec tree "
                         f"{len(spec_tree)}")
    return [_map(fn, t, s, f"{path}{i}/")
            for i, (t, s) in enumerate(zip(tree, spec_tree))]


def sanitize_specs(shapes_tree, spec_tree, mesh):
    """``sanitize_spec`` over a tree; ``shapes_tree`` holds tensors (or
    anything with ``.shape``) or shape tuples."""
    def one(_, x, s):
        return sanitize_spec(tuple(getattr(x, "shape", x)), s, mesh)

    return _map(one, shapes_tree, spec_tree)


class Layout(NamedTuple):
    """Where a leaf is split after sanitising: its spec, the dim split
    over 'model' (None: whole on every model rank) and the dim split over
    'data' (None: not split; only the gradient and the optimizer state
    are split there, ZeRO-2)."""

    spec: P
    model_dim: Optional[int]
    data_dim: Optional[int]


def _axis_dim(spec: P, axis: str) -> Optional[int]:
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


def layouts(params, spec_tree, mesh):
    """The ``Layout`` of every leaf (full-size ``params``); a quantized
    leaf (an int8 dict, at n_model = 1 only) stays whole."""
    def one(_, x, s):
        if _is_quantized(x):
            return Layout(P(), None, None)
        sp = sanitize_spec(tuple(x.shape), s, mesh)
        return Layout(sp, _axis_dim(sp, "model"), _axis_dim(sp, "data"))

    return _map(one, params, spec_tree)


def check_tensor_parallel(cfg, n_model: int):
    """Refuse an ``n_model`` that would put a shard boundary inside a head
    or split the residual width unevenly: it must divide the Llama query
    and KV heads, its FFN and hidden widths, and the encoder's heads and
    FFN width (ROADMAP §3)."""
    if n_model <= 1:
        return
    ll, w = cfg.llama, cfg.w2v2
    widths = {
        "llama num_heads": ll.num_heads,
        "llama num_kv_heads": ll.num_kv_heads,
        "llama intermediate_size": ll.intermediate_size,
        "llama hidden_size (the adapter's output)": ll.hidden_size,
        "w2v2 encoder_attention_heads": w.encoder_attention_heads,
        "w2v2 encoder_ffn_embed_dim": w.encoder_ffn_embed_dim,
    }
    bad = {k: v for k, v in widths.items() if v % n_model}
    if bad:
        raise ValueError(
            f"n_model={n_model} does not divide {bad}: a shard boundary "
            "inside a head or an uneven split of these widths is not "
            "ported (ROADMAP §3)")


def _is_quantized(x) -> bool:
    return isinstance(x, dict) and ("q" in x or "q_kmajor" in x)


def _has_quantized(tree) -> bool:
    if _is_quantized(tree):
        return True
    if isinstance(tree, dict):
        return any(_has_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_quantized(v) for v in tree)
    return False


def _chunk(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    return t.chunk(n, dim)[r]


def shard_params(params, mesh, spec_tree, cfg=None):
    """This rank's slice of every leaf over 'model' (the parameters stay
    whole over 'data'), after ``sanitize_spec``; returns (local params,
    layout tree).  With ``cfg`` an ``n_model`` that splits a head is
    refused (``check_tensor_parallel``); quantized parameters are refused
    under ``n_model > 1`` (the spec trees cover the float layout only, as
    the JAX package's do) and stay whole at ``n_model = 1``."""
    sizes = mesh_shape(mesh)
    n = sizes["model"]
    if n > 1 and _has_quantized(params):
        raise ValueError(
            f"quantized parameters under n_model={n}: tensor parallelism "
            "covers the float layout only (the JAX package's spec trees "
            "do not match a quantized tree); quantize after gathering, or "
            "run n_model=1")
    if cfg is not None:
        check_tensor_parallel(cfg, n)
    lay = layouts(params, spec_tree, mesh)
    r = mesh.get_local_rank("model") if n > 1 else 0

    def one(_, x, lt):
        if lt.model_dim is None:
            return x
        return _chunk(x, lt.model_dim, n, r).contiguous()

    return _map(one, params, lay), lay


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather ``t`` over ``group`` and concatenate along ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_params(local, mesh, layout_tree):
    """The inverse of ``shard_params``: every leaf whole, gathered over
    'model' (a collective: every rank calls it)."""
    n = mesh_shape(mesh)["model"]

    def one(_, x, lt):
        if lt.model_dim is None or n == 1:
            return x
        return gather_dim(x, lt.model_dim, mesh.get_group("model"))

    return _map(one, local, layout_tree)


def layout_leaves(layout_tree):
    """The ``Layout`` leaves in the order of ``train.step.tree_leaves``
    (dict keys sorted, lists in order)."""
    if isinstance(layout_tree, Layout):
        return [layout_tree]
    if isinstance(layout_tree, dict):
        return [x for k in sorted(layout_tree)
                for x in layout_leaves(layout_tree[k])]
    return [x for v in layout_tree for x in layout_leaves(v)]
