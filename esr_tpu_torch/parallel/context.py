"""Sequence (context) parallelism: ring attention and Ulysses attention
over a process group (counterpart of ``esr_tpu/parallel/context.py``).

The sequence axis of ``q, k, v [B, N, H, D]`` is split over the ``p``
processes of a group, process ``r`` holding block ``r`` (``[B, N/p, H, D]``,
the local view ``shard_map`` gives the reference's inner functions). Each
function takes the process's block and returns its block of the output:

- :func:`ring_attention`: the K/V blocks go round the ring (to ``rank +
  1``) while an online softmax (:func:`attention_block`, with the
  reference's guard for fully masked rows) folds each into the running max,
  denominator and unnormalized output; ``p`` steps, one rotation between
  two. The rotation (:class:`RingShift`) is a ``torch.autograd.Function``
  over ``dist.batch_isend_irecv`` whose backward sends the gradient the
  other way, so its gradients are those of ``jax.grad`` through
  ``ppermute``. K and V travel as one tensor, so the backward's rotations
  run in one order on every process. The causal mask comes from the blocks'
  global offsets.
- :func:`ulysses_attention`: an all-to-all (:class:`AllToAll`, its own
  transpose in the backward) turns the sequence split into a heads split,
  each process attends over the whole sequence for ``H/p`` heads, and a
  second all-to-all turns it back; ``H`` must divide by ``p``.
- :func:`full_attention`: the plain softmax attention on one process.

Everything is f32 einsums (no fused attention kernel: the reference's
function is the einsum; the JAX package has no Pallas kernel here), with
TF32 off on the card (``esr_tpu_torch.device``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _ring_peers(group) -> Tuple[int, int, int, int]:
    """``(index, size, next, previous)`` of this process in ``group``; the
    peers as global ranks."""
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    index = dist.get_rank(group)
    return (index, size, dist.get_global_rank(group, (index + 1) % size),
            dist.get_global_rank(group, (index - 1) % size))


def _shift(x: torch.Tensor, to: int, source: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``to`` and receive its like from
    ``source``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, source, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class RingShift(torch.autograd.Function):
    """``y`` on process ``r`` is ``x`` of process ``r - 1`` (``ppermute``
    with ``j -> j + 1``); the cotangent of ``x`` on ``r`` is that of ``y``
    on ``r + 1``."""

    @staticmethod
    def forward(ctx, x, group):
        _, _, nxt, prv = _ring_peers(group)
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _shift(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.prv, ctx.nxt, ctx.group), None


def attention_block(q, k, v, m, l, o, mask: Optional[torch.Tensor], scale: float):
    """One online-softmax update: ``q [B, nq, H, D]``, ``k, v [B, nk, H,
    D]``; carries the running max ``m`` and denominator ``l`` (``[B, nq,
    H]``) and the unnormalized output ``o``. A row masked so far keeps its
    max at -inf; the shift it is taken from is then 0, so ``exp`` gives 0,
    not NaN."""
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
    p = torch.exp(scores - m_safe[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention of the process's query block over the whole
    sequence, the K/V blocks going round ``group`` (None: the world);
    returns the process's output block ``[B, N/p, H, D]``."""
    index, size, _, _ = _ring_peers(group)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, nq, h), -torch.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, nq, h), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    kv = torch.stack([k, v])
    for step in range(size):
        # the block held now came from process (index - step)
        src = (index - step) % size
        mask = None
        if causal:
            q_pos = index * nq + torch.arange(nq, device=q.device)
            k_pos = src * nk + torch.arange(nk, device=q.device)
            mask = q_pos[None, :, None, None] >= k_pos[None, None, None, :]
        m, l, o = attention_block(q, kv[0], kv[1], m, l, o, mask, scale)
        if step + 1 < size:
            kv = RingShift.apply(kv, group)
    return o / torch.clamp_min(l, 1e-38)[..., None]


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal splits along dim 0."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """Chunk ``j`` of dim 0 goes to process ``j``; the result's chunk ``j``
    came from process ``j``. A permutation that is its own transpose, so the
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _seq_to_heads(x: torch.Tensor, p: int, group) -> torch.Tensor:
    """``[B, N/p, H, D]`` split on the sequence -> ``[B, N, H/p, D]`` split
    on the heads."""
    b, n, h, d = x.shape
    x = x.reshape(b, n, p, h // p, d).permute(2, 0, 1, 3, 4)
    x = AllToAll.apply(x, group)  # [p (sequence block), B, N/p, H/p, D]
    return x.permute(1, 0, 2, 3, 4).reshape(b, p * n, h // p, d)


def _heads_to_seq(x: torch.Tensor, p: int, group) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    b, n, hp, d = x.shape
    x = x.reshape(b, p, n // p, hp, d).permute(1, 0, 2, 3, 4)
    x = AllToAll.apply(x, group)  # [p (head block), B, N/p, H/p, D]
    return x.permute(1, 2, 0, 3, 4).reshape(b, n // p, p * hp, d)


def _softmax_attention(q, k, v, causal: bool) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if causal:
        n = q.shape[1]
        keep = torch.arange(n, device=q.device)[:, None] >= torch.arange(n, device=q.device)
        scores = torch.where(keep[None, :, None, :], scores, -torch.inf)
    return torch.einsum("bqhk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                      causal: bool = False) -> torch.Tensor:
    """Attention with the split moved from the sequence to the heads and
    back (module docstring); raises ``ValueError`` when the heads do not
    divide over ``group`` (None: the world)."""
    p = dist.get_world_size(group)
    if q.shape[2] % p != 0:
        raise ValueError(f"num_heads {q.shape[2]} must divide by the group's size {p}")
    qh, kh, vh = (_seq_to_heads(t, p, group) for t in (q, k, v))
    return _heads_to_seq(_softmax_attention(qh, kh, vh, causal), p, group)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Plain softmax attention ``[B, N, H, D]`` on one process."""
    return _softmax_attention(q, k, v, causal)
