"""Logit processors over fixed-size token buffers; port of the beam-path
processors in ``infinisst_tpu/decode/logits.py`` (HF semantics, applied to
log-softmax scores in HF order).

All take (B, V) scores and (B, T) token buffers with explicit valid
lengths.
"""

from __future__ import annotations

import torch

from infinisst_tpu_torch.parallel import collectives as par

NEG_INF = -1e9


def _presence(V: int, tokens: torch.Tensor, flags: torch.Tensor):
    """(B, V) bool: True where some token with a True flag has that id.
    Ids past the vocabulary mark nothing, as the JAX package's scatter
    drops them."""
    out = torch.zeros((tokens.shape[0], V), dtype=torch.float32,
                      device=tokens.device)
    tokens = tokens.to(torch.int64)
    flags = flags & (tokens < V)
    out.scatter_reduce_(1, tokens.clamp(max=V - 1), flags.to(torch.float32),
                        reduce="amax")
    return out > 0


def repetition_penalty(scores, tokens, valid, penalty: float):
    """score > 0 -> score / penalty, else score * penalty, for every token
    present (valid) in the sequence."""
    if penalty == 1.0:
        return scores
    present = _presence(scores.shape[-1], tokens, valid)
    penalized = torch.where(scores > 0, scores / penalty, scores * penalty)
    return torch.where(present, penalized, scores)


def _ngram_bans(V: int, source, source_valid_len, suffix, have_suffix):
    """(B, V) bool, True = banned: token source[i + n - 1] whenever
    source[i : i + n - 1] == suffix and the window lies in the valid span."""
    B, Ts = source.shape
    nm1 = suffix.shape[1]
    n_windows = Ts - nm1
    if n_windows <= 0:
        return torch.zeros((B, V), dtype=torch.bool, device=source.device)
    dev = source.device
    idx = (torch.arange(n_windows, device=dev)[:, None]
           + torch.arange(nm1, device=dev)[None, :])
    windows = source[:, idx]  # (B, W, n-1)
    match = (windows == suffix[:, None, :]).all(dim=-1)
    win_end = torch.arange(n_windows, device=dev) + nm1
    in_valid = win_end[None, :] <= source_valid_len[:, None] - 1
    match = match & in_valid & have_suffix[:, None]
    banned_tok = source[:, torch.clamp(win_end, max=Ts - 1)]  # (B, W)
    return _presence(V, banned_tok, match)


def _tail(tokens, valid_len, nm1):
    """Last nm1 tokens before valid_len (dynamic_slice start clamping)."""
    T = tokens.shape[1]
    start = torch.clamp(valid_len - nm1, min=0, max=T - nm1)
    idx = start[:, None] + torch.arange(nm1, device=tokens.device)[None]
    return torch.gather(tokens, 1, idx)


def no_repeat_ngram(scores, tokens, valid_len, ngram_size: int):
    if ngram_size <= 0:
        return scores
    nm1 = ngram_size - 1
    suffix = _tail(tokens, valid_len, nm1)
    have = valid_len >= nm1 + 1
    bans = _ngram_bans(scores.shape[-1], tokens, valid_len, suffix, have)
    return torch.where(bans, torch.full_like(scores, NEG_INF), scores)


def encoder_no_repeat_ngram(scores, history, history_len, tokens,
                            valid_len, ngram_size: int):
    """Ban continuations of (n-1)-grams of the cross-chunk target history."""
    if ngram_size <= 0:
        return scores
    nm1 = ngram_size - 1
    suffix = _tail(tokens, valid_len, nm1)
    have = valid_len >= nm1
    bans = _ngram_bans(scores.shape[-1], history, history_len, suffix, have)
    return torch.where(bans, torch.full_like(scores, NEG_INF), scores)


def suppress_tokens(scores, mask):
    """mask: (V,) bool, True = suppress."""
    return torch.where(mask[None, :], torch.full_like(scores, NEG_INF), scores)


def process_scores(scores, seq_buf, seq_len, penalty: float,
                   ngram_size: int, history, history_len,
                   encoder_ngram_size: int, suppress_mask=None):
    """The decoders' processors on (B, V) log-softmax scores, in HF order:
    repetition penalty and no-repeat-ngram over each row's sequence
    buffer (B, T) up to seq_len, encoder-no-repeat-ngram over its
    cross-chunk history, then the suppressed ids."""
    valid = torch.arange(seq_buf.shape[1], device=scores.device)[None] < \
        seq_len[:, None]
    scores = repetition_penalty(scores, seq_buf, valid, penalty)
    scores = no_repeat_ngram(scores, seq_buf, seq_len, ngram_size)
    scores = encoder_no_repeat_ngram(scores, history, history_len, seq_buf,
                                     seq_len, encoder_ngram_size)
    if suppress_mask is not None:
        scores = suppress_tokens(scores, suppress_mask)
    return scores


# ---------------------------------------------------------------------------
# The sampling filters (HF order: temperature -> top-k -> top-p -> epsilon)


def temperature_scale(logits, temperature: float):
    return logits / max(temperature, 1e-6)


def top_k_filter(logits, k: int):
    """Keep every score >= the k-th largest (ties at the k-th all stay)."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])  # HF clamps k to the vocabulary
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits, p: float):
    """Keep the smallest prefix of the descending scores whose mass
    reaches p, the token that crosses p included (and always the top
    one); ties at the threshold all stay."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = cum - probs > p
    inf = torch.full_like(sorted_logits, float("inf"))
    threshold = torch.where(cutoff, inf, sorted_logits).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF),
                       logits)


def epsilon_filter(logits, eps: float):
    """Drop tokens whose probability is below eps; the top-1 token (the
    first maximum) always stays."""
    if eps <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.arange(logits.shape[-1], device=logits.device) == \
        torch.argmax(logits, dim=-1, keepdim=True)
    return torch.where((probs < eps) & ~top1,
                       torch.full_like(logits, NEG_INF), logits)


def sample_scores(logits, seq_buf, seq_len, spec, history, history_len,
                  encoder_ngram_size: int, suppress_mask=None):
    """The sampling decoders' processors on (B, V) raw logits, in the
    order of the JAX ``sample_decode``: temperature, log-softmax, the
    beam path's processors (``process_scores``), then top-k, top-p and
    epsilon.  ``spec`` carries temperature, top_k, top_p,
    epsilon_cutoff, repetition_penalty and no_repeat_ngram_size."""
    scores = torch.log_softmax(
        temperature_scale(logits.to(torch.float32), spec.temperature), -1)
    scores = process_scores(
        scores, seq_buf, seq_len, spec.repetition_penalty,
        spec.no_repeat_ngram_size, history, history_len, encoder_ngram_size,
        suppress_mask,
    )
    scores = top_k_filter(scores, spec.top_k)
    scores = top_p_filter(scores, spec.top_p)
    return epsilon_filter(scores, spec.epsilon_cutoff)


def categorical(scores, generator):
    """One draw per row from softmax(scores) (B, V) by the Gumbel-max
    trick, with noise from ``generator`` (on the scores' device);
    -inf and NEG_INF scores are never drawn next to a finite one."""
    u = par.pool_rand(scores.shape, generator, scores.device)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def chunk_seed(seed: int, index: int) -> int:
    """The seed of chunk (or tick) ``index``'s draws in a stream seeded
    with ``seed``."""
    return (int(seed) * 1_000_003 + int(index)) % (2 ** 63)


def chunk_generator(seed: int, index: int, device) -> torch.Generator:
    """The draws of chunk (or tick) ``index`` of a stream seeded with
    ``seed``: a generator on ``device`` seeded from the pair, fresh for
    every index and the same for the same pair (a captured program
    reseeds its own generator with ``chunk_seed`` instead)."""
    g = torch.Generator(device=device)
    g.manual_seed(chunk_seed(seed, index))
    return g
