"""wav2vec2-style chunked-causal speech encoder; port of
``infinisst_tpu/models/wav2vec2.py``: the streaming ``chunk_step`` and the
offline / training ``forward`` (with gradient checkpointing and the
fairseq training dropout).

- conv feature extractor (7 layers, stride 320), 'layer_norm' mode (per
  layer LayerNorm, vox/large) or 'default' (GroupNorm on layer 0), with
  the conv biases of the LV-60 checkpoints;
- pre-LN transformer with block-causal streaming attention and
  interleaved RoPE over cache-relative positions, a Python loop over
  stacked layer parameters.

Parameters (dense weights stored (in, out), as in the JAX package):
  conv: [{w: (k, in, out), b, ln_scale, ln_bias}] * 7; post_ln {scale,
  bias}; post_proj {w, b}; layers (stacked, L first): ln1/ln2 scale+bias,
  wq/wk/wv/wo (L, D, D), bq/bk/bv/bo, fc1_w (L, D, F), fc1_b, fc2_w
  (L, F, D), fc2_b; final_ln {scale, bias}.

Under tensor parallelism (``parallel/mesh.py``) a rank holds a block of
the heads (wq/wk/wv's output columns with bq/bk/bv, wo's rows), of
fc1's columns and fc2's rows, and of post_proj's output columns: f
(``copy_to_model``) goes before the column-parallel products, g
(``reduce_from_model``) after wo and fc2, then their replicated biases
bo and fc2_b are added once, and the training dropout after them;
post_proj's output is gathered before its replicated bias.  The local
head count is read from wq's shape; the cache holds the rank's heads.

Under FSDP (the 'data' axis with ``zero``) the extractor, norms and
post_proj are gathered once a forward, each layer where the loop slices
it (inside the checkpointed function under remat).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from infinisst_tpu_torch.core import masks as M
from infinisst_tpu_torch.core import rope as R
from infinisst_tpu_torch.core.config import W2V2Config
from infinisst_tpu_torch.parallel import collectives as par
from infinisst_tpu_torch.streaming.state import EncoderState

Params = Dict[str, Any]


def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _gelu(x):
    # fairseq/torch default GELU is the exact (erf) variant
    return F.gelu(x, approximate="none")


def _group_norm_per_channel(h, scale, bias, eps=1e-5):
    """GroupNorm(dim, dim) on (B, C, T): each channel over its own time."""
    hf = h.to(torch.float32)
    mu = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (hf - mu) * torch.rsqrt(var + eps)
    return (
        y * scale.to(torch.float32)[None, :, None]
        + bias.to(torch.float32)[None, :, None]
    ).to(h.dtype)


def conv_extractor(params: Params, cfg: W2V2Config, x: torch.Tensor):
    """(B, T) raw samples -> (B, frames, conv_dim); valid convolutions."""
    h = x[:, None, :]  # (B, 1, T)
    for i, (lc, p) in enumerate(zip(cfg.conv_layers, params["conv"])):
        h = F.conv1d(h.to(p["w"].dtype), p["w"].permute(2, 1, 0),
                     stride=lc.stride)
        if "b" in p:
            h = h + p["b"].to(h.dtype)[None, :, None]
        if cfg.extractor_mode == "layer_norm":
            h = _gelu(_layer_norm(h.transpose(1, 2), p["ln_scale"],
                                  p["ln_bias"])).transpose(1, 2)
        else:
            if i == 0:
                h = _group_norm_per_channel(h, p["gn_scale"], p["gn_bias"])
            h = _gelu(h)
    return h.transpose(1, 2)


def sinusoidal_positions(offset, length: int, d_model: int, device=None):
    """Absolute sinusoidal embeddings [sin | cos] (the abs-pos fallback
    when RoPE is off), computed in f32: (length, d_model) for an int
    offset, (B, length, d_model) for a (B,) tensor of offsets (read on
    the device)."""
    half = d_model // 2
    if torch.is_tensor(offset):
        pos = offset.to(device=device, dtype=torch.float32)
    else:  # a fill, not an upload: capture-safe
        pos = torch.full((), float(offset), dtype=torch.float32,
                         device=device)
    device = pos.device
    freq = torch.exp(
        torch.arange(half, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / (half - 1))
    )
    pos = pos[..., None] + torch.arange(length, dtype=torch.float32,
                                        device=device)
    ang = pos[..., None] * freq
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if d_model % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros(emb.shape[:-1] + (1,))], dim=-1)
    return emb


def conv_out_length(cfg: W2V2Config, length):
    """Frames the extractor makes of ``length`` samples (valid convs)."""
    for lc in cfg.conv_layers:
        length = (length - lc.kernel) // lc.stride + 1
    return length


def dropout_seed_of(seed: int, step: int) -> int:
    """The seed of one training step's dropout generator, from (seed,
    step)."""
    s = np.random.SeedSequence([seed % 2**64, step % 2**64])
    return int(s.generate_state(1, np.uint64)[0]) >> 1


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step's dropout masks: seeded from
    (seed, step) as the JAX step folds ``step`` into ``PRNGKey(seed)``, so
    every step draws new masks and a (seed, step) pair always the same
    ones (the draws themselves are not JAX's)."""
    return torch.Generator(device=device).manual_seed(
        dropout_seed_of(seed, step))


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, device) -> torch.Tensor:
    """The encoder's RoPE frequencies on ``device``, uploaded once (a
    blocking host copy per forward would make the host wait for the work
    queued before it)."""
    return torch.tensor(R.encoder_rope_freqs(head_dim), dtype=torch.float32,
                        device=device)


def _keep_mask(gen, shape, rate, device):
    """Bernoulli(1 - rate) keep mask, bool."""
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def _drop(t, keep, rate):
    """Inverted dropout: kept entries scaled by 1 / (1 - rate)."""
    if keep is None:
        return t
    return torch.where(keep, t / (1.0 - rate), 0.0)


def _attention(q, k, v, bias, q_pos, k_pos, cfg: W2V2Config, inv_freq):
    """q (B, S, H, Dh), k/v (B, K, H, Dh) unrotated; bias (B, 1, S, K)."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if cfg.use_rope:
        xb = cfg.xpos_scale_base if cfg.use_xpos else None
        q = R.apply_encoder_rope(q, q_pos, inv_freq, xb, xpos_downscale=False)
        k = R.apply_encoder_rope(k, k_pos, inv_freq, xb, xpos_downscale=True)
    logits = torch.einsum(
        "bhsd,bhkd->bhsk", q.to(torch.float32), k.to(torch.float32)
    )
    logits = logits * scale + bias.to(torch.float32)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhsk,bhkd->bhsd", w, v)
    return out.transpose(1, 2)  # (B, S, H, Dh)


def _split_heads(x, n_heads):
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads)


def _layer(lp, cfg: W2V2Config, h, bias, q_pos, k_pos, inv_freq,
           cache=None, keep=(None, None), rate=0.0):
    """One pre-LN transformer layer over h (B, S, D) attending to [cache |
    h]; ``keep`` holds the dropout masks of its attention and FFN outputs.
    Its 'data' shards are gathered first.  Returns (h, k_new, v_new), the
    chunk's own unrotated K/V."""
    lp = par.unshard_tree(lp)
    H = _local_heads(lp["wq"], cfg)
    y = par.copy_to_model(_layer_norm(h, lp["ln1_scale"], lp["ln1_bias"]))
    q = _split_heads(y @ lp["wq"] + lp["bq"], H)
    k_n = _split_heads(y @ lp["wk"] + lp["bk"], H)
    v_n = _split_heads(y @ lp["wv"] + lp["bv"], H)
    if cache is not None:
        k = torch.cat([cache[0], k_n.to(cache[0].dtype)], dim=1)
        v = torch.cat([cache[1], v_n.to(cache[1].dtype)], dim=1)
    else:
        k, v = k_n, v_n
    attn = _attention(q, k, v, bias, q_pos, k_pos, cfg, inv_freq)
    attn = par.reduce_from_model(
        attn.reshape(*attn.shape[:2], -1) @ lp["wo"]) + lp["bo"]
    h = h + _drop(attn, keep[0], rate)
    y = par.copy_to_model(_layer_norm(h, lp["ln2_scale"], lp["ln2_bias"]))
    y = _gelu(y @ lp["fc1_w"] + lp["fc1_b"])
    h = h + _drop(par.reduce_from_model(y @ lp["fc2_w"]) + lp["fc2_b"],
                  keep[1], rate)
    return h, k_n, v_n


def _offline_layer(lp, cfg, h, bias, pos, inv_freq, keep, rate):
    return _layer(lp, cfg, h, bias, pos, pos, inv_freq, keep=keep,
                  rate=rate)[0]


def _encoder_stack(params, cfg: W2V2Config, x, bias, q_pos, k_pos,
                   cache_kv, inv_freq):
    """Run the transformer layers over x (B, S, D) attending to
    [cache | chunk]; returns (output, (new_k, new_v)) with the chunk's
    per-layer K/V stacked as (L, B, S, H, Dh)."""
    layers = params["layers"]
    h = x
    new_k, new_v = [], []
    for li in range(layers["wq"].shape[0]):
        lp = {k: par.layer_slice(v, li) for k, v in layers.items()}
        h, k_n, v_n = _layer(lp, cfg, h, bias, q_pos, k_pos, inv_freq,
                             cache=(cache_kv[0][li], cache_kv[1][li]))
        new_k.append(k_n)
        new_v.append(v_n)
    fl = par.unshard_tree(params["final_ln"])
    h = _layer_norm(h, fl["scale"], fl["bias"])
    return h, (torch.stack(new_k), torch.stack(new_v))


def _prep_frames(params: Params, cfg: W2V2Config, samples: torch.Tensor):
    """Conv extractor + post LayerNorm + projection to the encoder dim."""
    params = par.unshard_tree({k: params[k]
                               for k in ("conv", "post_ln", "post_proj")})
    feats = conv_extractor(params, cfg, samples)
    feats = _layer_norm(feats, params["post_ln"]["scale"],
                        params["post_ln"]["bias"])
    w, b = params["post_proj"]["w"], params["post_proj"]["b"]
    if w.shape[-1] < b.shape[-1]:  # split over 'model': gather, then b
        par.split_width(w.shape[-1], b.shape[-1], "w2v2 post_proj columns")
        return par.gather_from_model(par.copy_to_model(feats) @ w, -1) + b
    return feats @ w + b


def local_heads(params: Params, cfg: W2V2Config) -> int:
    """The encoder heads this rank holds (all on one card, H/n under
    tensor parallelism), from wq's shape."""
    return _local_heads(params["layers"]["wq"], cfg)


def _local_heads(wq, cfg: W2V2Config) -> int:
    return par.split_width(wq.shape[-1] // cfg.head_dim,
                           cfg.encoder_attention_heads, "w2v2 heads")


def forward(
    params: Params,
    cfg: W2V2Config,
    samples: torch.Tensor,  # (B, T) raw audio, the 399-sample offset included
    block_frames: int,
    max_cache_frames: int,
    frame_lengths: Optional[torch.Tensor] = None,  # (B,) valid frames
    remat: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.1,
    dropout_rows: Optional[Tuple[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Offline / training forward over a fresh cache with the block-causal
    mask (``block_frames = max_cache_frames = 10**7`` makes it
    bidirectional, as the AlignAtt agent runs it).  With ``frame_lengths``
    the frames at and past a row's length are zeroed and never attended.
    Returns (B, frames, encoder_dim).

    With ``dropout_gen`` (``dropout_generator``) the fairseq training
    dropout at ``dropout_rate`` hits the input and each layer's attention
    and FFN outputs; with ``dropout_rows = (B, rows)`` each mask is drawn
    over a batch of B rows and the given rows of it are kept (a data rank
    of the sharded step draws the whole batch's masks, so that its rows
    get the one-card step's).  ``remat`` checkpoints each layer; its
    masks are drawn
    before the layer runs and passed in, so the backward pass's replay
    applies the same ones.  No per-layer K/V is kept (there is no cache to
    append it to)."""
    x = _prep_frames(params, cfg, samples)
    B, F_, D = x.shape
    dev = x.device
    mask = M.block_causal_mask(F_, max_cache_frames, block_frames,
                               device=dev)[None, None]  # (1, 1, F, F)
    if frame_lengths is not None:
        fl = torch.as_tensor(frame_lengths, device=dev)
        j = torch.arange(F_, device=dev)
        mask = mask & (j[None, None, None, :] < fl[:, None, None, None])
        x = x * (j[None, :, None] < fl[:, None, None]).to(x.dtype)
    bias = M.additive(mask)
    pos = torch.arange(F_, device=dev)[None].expand(B, F_)
    inv_freq = _inv_freq(cfg.head_dim, dev)
    if not cfg.use_rope:
        x = x + sinusoidal_positions(0, F_, D, dev)[None].to(x.dtype)

    def keep():
        if dropout_gen is None:
            return None
        if dropout_rows is not None:
            full = (dropout_rows[0],) + tuple(x.shape[1:])
            return _keep_mask(dropout_gen, full, dropout_rate,
                              dev)[dropout_rows[1]]
        return _keep_mask(dropout_gen, x.shape, dropout_rate, dev)

    h = _drop(x, keep(), dropout_rate)
    layers = params["layers"]
    for li in range(layers["wq"].shape[0]):
        lp = {k: par.layer_slice(v, li) for k, v in layers.items()}
        args = (lp, cfg, h, bias, pos, inv_freq, (keep(), keep()),
                dropout_rate)
        # the layer draws no random numbers (its masks are arguments), so
        # the replay needs no saved RNG state
        h = (checkpoint(_offline_layer, *args, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _offline_layer(*args))
    fl = par.unshard_tree(params["final_ln"])
    return _layer_norm(h, fl["scale"], fl["bias"])


def chunk_step(
    params: Params,
    cfg: W2V2Config,
    state: EncoderState,
    window: torch.Tensor,  # (B, CONV_LEFT_CONTEXT + 2 * chunk_samples)
    chunk_frames: int,
    max_cache_frames: int,
    row_frames: Optional[torch.Tensor] = None,  # (B,) real new frames
) -> Tuple[torch.Tensor, EncoderState]:
    """Encode one chunk against the right-aligned sliding-window cache.
    The conv runs over the whole window and the first ``chunk_frames``
    outputs (the previous chunk's) are dropped.

    ``row_frames`` mixes chunk sizes in one call (the mixed-multiplier
    serving pool): ``chunk_frames`` is then the padded maximum and row i
    carries ``row_frames[i]`` real new frames, right-aligned in its
    window.  Its conv outputs are left-aligned, its chunk is one
    attention block, only its real new keys are attended, and its ring
    slides by exactly ``row_frames[i]``: a row with 0 frames passes
    through unchanged.  Returns (frames (B, chunk_frames, D), real rows
    left-aligned; new state)."""
    x = _prep_frames(params, cfg, window)[:, -chunk_frames:]
    B, S, D = x.shape
    C = state.k.shape[2]
    dev = x.device
    n = state.n_frames.to(dev)  # (B,)
    rf = None
    if row_frames is not None:
        rf = torch.as_tensor(row_frames, dtype=torch.int64, device=dev)
        # left-align each row's (right-aligned) real conv outputs
        src = torch.clamp(S - rf[:, None] + torch.arange(S, device=dev)[None],
                          0, S - 1)
        x = torch.gather(x, 1, src[:, :, None].expand(B, S, D))
    if not cfg.use_rope:
        # abs-pos fallback at the ABSOLUTE stream offset
        x = x + sinusoidal_positions(n, S, D, dev).to(x.dtype)
    mask = M.streaming_chunk_mask(S, n, max_cache_frames,
                                  chunk_frames if rf is None else rf, C + S)
    if rf is not None:
        # only the first row_frames[i] new keys are real
        kj = torch.arange(C + S, device=dev)[None, None]
        mask = mask & ((kj < C) | (kj - C < rf[:, None, None]))
    bias = M.additive(mask)[:, None]  # (B, 1, S, C+S)
    valid = torch.clamp(n, max=C)[:, None]
    k_pos = torch.arange(C + S, device=dev)[None] - (C - valid)
    q_pos = valid + torch.arange(S, device=dev)[None]
    inv_freq = _inv_freq(cfg.head_dim, dev)
    out, (nk, nv) = _encoder_stack(
        params, cfg, x, bias, q_pos, k_pos, (state.k, state.v), inv_freq
    )
    if rf is None:
        # right-aligned sliding append: drop the oldest S slots, add the
        # chunk
        new_k = torch.cat([state.k[:, :, S:], nk.to(state.k.dtype)], dim=2)
        new_v = torch.cat([state.v[:, :, S:], nv.to(state.v.dtype)], dim=2)
        return out, EncoderState(k=new_k, v=new_v, n_frames=n + S)
    # per-row shift append: row i's ring slides by row_frames[i]
    idx = (rf[:, None] + torch.arange(C, device=dev)[None])[None, :, :, None,
                                                             None]

    def shift(buf, new):
        full = torch.cat([buf, new.to(buf.dtype)], dim=2)  # (L, B, C+S, H, Dh)
        return torch.gather(full, 2, idx.expand(
            full.shape[0], B, C, full.shape[3], full.shape[4]))

    return out, EncoderState(k=shift(state.k, nk), v=shift(state.v, nv),
                             n_frames=n + rf)


def init_params(cfg: W2V2Config, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> Params:
    """Random parameters in the JAX package's layout, made on device."""
    D, F_, L = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, \
        cfg.encoder_layers
    conv_dim = cfg.conv_layers[-1].dim

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    conv = []
    in_d = 1
    for i, lc in enumerate(cfg.conv_layers):
        w = normal((lc.kernel, in_d, lc.dim)) * math.sqrt(
            2.0 / (lc.kernel * in_d)
        )
        entry = {"w": w.to(dtype)}
        if cfg.conv_bias:
            entry["b"] = zeros((lc.dim,))
        if cfg.extractor_mode == "layer_norm":
            entry["ln_scale"] = ones((lc.dim,))
            entry["ln_bias"] = zeros((lc.dim,))
        elif i == 0:
            entry["gn_scale"] = ones((lc.dim,))
            entry["gn_bias"] = zeros((lc.dim,))
        conv.append(entry)
        in_d = lc.dim

    def stacked(shape):
        return (normal((L,) + shape) / math.sqrt(shape[0])).to(dtype)

    layers = {
        "ln1_scale": ones((L, D)), "ln1_bias": zeros((L, D)),
        "ln2_scale": ones((L, D)), "ln2_bias": zeros((L, D)),
        "wq": stacked((D, D)), "wk": stacked((D, D)),
        "wv": stacked((D, D)), "wo": stacked((D, D)),
        "bq": zeros((L, D)), "bk": zeros((L, D)),
        "bv": zeros((L, D)), "bo": zeros((L, D)),
        "fc1_w": stacked((D, F_)), "fc1_b": zeros((L, F_)),
        "fc2_w": stacked((F_, D)), "fc2_b": zeros((L, D)),
    }
    return {
        "conv": conv,
        "post_ln": {"scale": ones((conv_dim,)), "bias": zeros((conv_dim,))},
        "post_proj": {
            "w": (normal((conv_dim, D)) / math.sqrt(conv_dim)).to(dtype),
            "b": zeros((D,)),
        },
        "layers": layers,
        "final_ln": {"scale": ones((D,)), "bias": zeros((D,))},
    }
