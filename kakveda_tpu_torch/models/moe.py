"""Sparse Mixture-of-Experts MLP (the Mixtral family).

Counterpart of ``kakveda_tpu/models/moe.py``, with the same semantics:

* **Routing** (:func:`router_topk`): an f32 softmax over every expert's
  logit, the top k, the kept weights renormalized. Ties go to the lowest
  expert index, as ``jax.lax.top_k`` breaks them: ``torch.topk`` fixes no
  tie order, so the top k is a stable descending sort.
* **Dispatch** (:func:`dispatch_slots`, :func:`dispatch`): the ``T·k``
  (token, choice) assignments sorted by expert with a stable sort; an
  assignment's position in its expert is its running index minus the
  expert's start, its slot ``expert·cap + position``. With a positive
  capacity factor the assignments past ``cap`` drop in position priority:
  they write to a spare row that is sliced off (the JAX ``mode="drop"``).
* **Compute** (:func:`expert_swiglu`): one batched SwiGLU over ``[E, cap,
  D]`` through ``torch.bmm`` on the stacked expert weights at compute dtype
  (dequantized by ``wmat`` when they are int8).
* **Combine** (:func:`combine`): each assignment's routing-weighted output,
  back in (token, choice) order, summed over the choices in a fixed order.
  For k ≤ 2 that equals the JAX scatter-add from zeros bit for bit.

Every shape is fixed by T, k, E and the capacity: no ``.item()``, no
boolean-mask indexing, no host copy. So the block neither waits for the card
nor stops a CUDA-graph capture of the decode step.

The load-balancing loss and ``return_aux`` are training work, not ported.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from kakveda_tpu_torch.models.llama import LlamaConfig, Params, wmat


def router_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights [T, k] f32, expert ids [T, k] int64, probs [T, E] f32):
    softmax over all experts in f32, the top k (lowest id first on a tie),
    the kept mass renormalized."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = probs.sort(dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return w, idx, probs


def expert_capacity(n_tokens: int, cfg: LlamaConfig) -> int:
    """Per-expert token capacity of a T-token dispatch: T (no drop) at a
    capacity factor ≤ 0, else ``ceil(T·k/E · factor)`` clamped to [1, T]."""
    f = cfg.expert_capacity_factor
    if f <= 0.0:
        return n_tokens
    k, e = cfg.n_experts_per_tok, cfg.n_experts
    return min(n_tokens, max(1, math.ceil(n_tokens * k / e * f)))


def dispatch_slots(idx: torch.Tensor, cap: int, n_experts: int):
    """The dispatch plan of ``idx [T, k]``, in expert-sorted order: (order
    [T·k] into the flat (token, choice) assignments, token of each, slot in
    the ``[E·cap]`` buffer (``E·cap`` when dropped), keep mask)."""
    t, k = idx.shape
    e_flat = idx.reshape(t * k)
    e_sorted, order = e_flat.sort(stable=True)
    tok_sorted = order // k
    counts = torch.zeros(n_experts, dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=idx.device) - starts[e_sorted]
    keep = pos < cap
    slot = torch.where(keep, e_sorted * cap + pos, torch.full_like(pos, n_experts * cap))
    return order, tok_sorted, slot, keep


def dispatch(xf: torch.Tensor, tok_sorted: torch.Tensor, slot: torch.Tensor, n_experts: int, cap: int):
    """Token rows ``xf [T, D]`` into the zero-filled ``[E, cap, D]`` expert
    buffer; dropped assignments land in a spare last row, sliced off."""
    buf = xf.new_zeros((n_experts * cap + 1, xf.shape[1]))
    buf.index_copy_(0, slot, xf[tok_sorted])
    return buf[: n_experts * cap].view(n_experts, cap, xf.shape[1])


def expert_swiglu(xe: torch.Tensor, layer: Params) -> torch.Tensor:
    """Batched SwiGLU of every expert: ``[E, cap, D] -> [E, cap, D]``."""
    dt = xe.dtype
    gate = F.silu(torch.bmm(xe, wmat(layer["we_gate"], dt)))
    up = torch.bmm(xe, wmat(layer["we_up"], dt))
    return torch.bmm(gate * up, wmat(layer["we_down"], dt))


def combine(ye, w, order, slot, keep, n_tokens: int) -> torch.Tensor:
    """Token rows ``[T, D]``: each kept assignment's expert output times its
    routing weight (cast to the output dtype), summed over the k choices in
    choice order onto zeros."""
    e, cap, d = ye.shape
    k = w.shape[-1]
    rows = ye.reshape(e * cap, d)[slot.clamp_max(e * cap - 1)]
    contrib = rows * (w.reshape(-1)[order] * keep.float()).to(ye.dtype)[:, None]
    per_choice = torch.empty_like(contrib).index_copy_(0, order, contrib).view(n_tokens, k, d)
    out = torch.zeros_like(per_choice[:, 0])
    for c in range(k):
        out = out + per_choice[:, c]
    return out


def moe_mlp(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """Sparse-MoE SwiGLU: ``x [B, S, D] -> [B, S, D]``. Layer params:
    ``router [D, E]`` (f32), stacked ``we_gate`` / ``we_up [E, D, F]`` and
    ``we_down [E, F, D]`` (dense or ``{"q", "s"}``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    t = b * s
    xf = x.reshape(t, d)
    w, idx, _ = router_topk(xf.float() @ layer["router"].float(), k)
    cap = expert_capacity(t, cfg)
    order, tok_sorted, slot, keep = dispatch_slots(idx, cap, e)
    ye = expert_swiglu(dispatch(xf, tok_sorted, slot, e, cap), layer)
    return combine(ye, w, order, slot, keep, t).reshape(b, s, d)


def moe_mlp_reference(x: torch.Tensor, layer: Params, cfg: LlamaConfig):
    """Plain per-token oracle of :func:`moe_mlp` at no-drop capacity, for
    the tests and the card's smoke run (it reads routes back to the host):
    each token's router logits in f32, a float64 softmax, its top k taken
    by (probability desc, expert asc) and renormalized, then a dense SwiGLU
    per chosen expert on the same weights at ``x``'s dtype (dequantized by
    ``wmat``), the weighted sum accumulated in f32. Returns (out [B, S, D]
    in ``x``'s dtype, chosen experts [T, k] int64 on the host)."""
    b, s, d = x.shape
    dt = x.dtype
    k = cfg.n_experts_per_tok
    xf = x.reshape(b * s, d)
    probs = torch.softmax((xf.float() @ layer["router"].float()).double(), dim=-1).cpu()
    experts = torch.tensor(
        [sorted(range(cfg.n_experts), key=lambda e, p=p: (-p[e], e))[:k] for p in probs.tolist()],
        dtype=torch.long,
    ).reshape(b * s, k)
    w = probs.gather(1, experts)
    w = (w / w.sum(dim=-1, keepdim=True)).float()
    wg, wu, wd = (wmat(layer[n], dt) for n in ("we_gate", "we_up", "we_down"))
    out = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    for i, chosen in enumerate(experts.tolist()):
        h = xf[i : i + 1]
        for c, e in enumerate(chosen):
            y = (F.silu(h @ wg[e]) * (h @ wu[e])) @ wd[e]
            out[i] += w[i, c].item() * y[0].float()
    return out.to(dt).reshape(b, s, d), experts
