"""Cached GQA attention for the Llama runtime, and the flash kernel's wrapper.

Counterpart of ``kakveda_tpu/models/attention.py``, same contract:

``gqa_cache_attention(q, k, v, pos0, kv_valid)``
    q          [B, S, H, D]   queries (prefill chunk or decode step)
    k, v       [B, KV, L, D]  head-major KV cache (cfg.dtype, or int8 with
                              ``k_scale``/``v_scale`` [B, KV, L] f32)
    pos0       int            cache slot of q[:, 0]
    kv_valid   [B, L] bool    optional per-slot validity (left-pad batching)
    -> [B, S, H, D]

* :func:`flash_gqa_cache` replaces the Pallas TPU kernel of the same name
  (``pl.pallas_call`` at ``kakveda_tpu/models/attention.py:284``, bodies
  ``_flash_kernel`` and ``_flash_kernel_kv8``). On a CUDA tensor it launches
  the hand-written kernel in ``kakveda_tpu_torch/csrc/flash_gqa_cache.cu``
  (built by ``nvcc`` for ``sm_90a`` at first use) or raises; on a CPU tensor
  it runs :func:`flash_gqa_cache_reference`, the plain version with the
  kernel's own semantics, which is also the kernel's oracle on the card.
* :func:`gqa_grouped` is the twin of ``_gqa_xla``: it serves only softcap
  and per-query ``full_mask`` attention, neither of which is on the serving
  path ported so far, and neither runs on the card yet.

One documented divergence between the two, as in the JAX package: a query
row with no visible slot (a left-pad position) emits zeros from the flash
path and a uniform average from the grouped path. Such rows are pad
positions whose activations never reach a real token's logits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kakveda_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_L_BLK = 64  # the CUDA kernel's cache tile


def gqa_grouped(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0: int,
    kv_valid: Optional[torch.Tensor],
    window: int = 0,
    softcap: float = 0.0,
    full_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped attention with the GQA group axis explicit (K/V are never
    repeated to H heads) — the twin of ``_gqa_xla``. ``full_mask`` [B, S, L]
    replaces the causal/window/kv_valid mask."""
    b, s, h, d = q.shape
    kv, l = k.shape[1], k.shape[2]
    r = h // kv
    q5 = q.reshape(b, s, kv, r, d).permute(0, 2, 1, 3, 4)  # [B, KV, S, R, D]
    scores = torch.einsum("bgsrd,bgld->bgsrl", q5, k).float() * d**-0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    if full_mask is not None:
        keep = full_mask[:, None, :, None, :]
    else:
        q_pos = pos0 + torch.arange(s, device=q.device)
        l_pos = torch.arange(l, device=q.device)
        mask = q_pos[:, None] >= l_pos[None, :]
        if window:
            mask &= (q_pos[:, None] - l_pos[None, :]) < window
        keep = mask[None, None, :, None, :]
        if kv_valid is not None:
            keep = keep & kv_valid[:, None, None, None, :]
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgsrl,bgld->bgsrd", probs, v)
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h, d).to(q.dtype)


def flash_gqa_cache_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0: int,
    kv_valid: Optional[torch.Tensor],
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel, step for step: the R group
    heads fold into the q rows (row i is position ``pos0 + i // R``), the
    cache streams in the kernel's 64-row tiles through an f32 online softmax,
    masked scores are −1e30 and p is masked again after the exp, P is cast to
    the cache's compute dtype before P·V, and the output is
    ``acc / max(l, 1e-20)`` — zeros for a row that sees no slot.

    An int8 cache dequantizes as ``int8.to(q.dtype) * scale.to(q.dtype)``
    (``_kv_dequant``'s order); a float cache casts q to the cache dtype."""
    b, s, h, d = q.shape
    kv, l = k.shape[1], k.shape[2]
    r = h // kv
    sr = s * r
    if k_scale is not None:
        kt = k.to(q.dtype) * k_scale.to(q.dtype)[..., None]
        vt = v.to(q.dtype) * v_scale.to(q.dtype)[..., None]
        qt = q
    else:
        kt, vt, qt = k, v, q.to(k.dtype)
    qf = qt.reshape(b, s, kv, r, d).permute(0, 2, 1, 3, 4).reshape(b, kv, sr, d).float()
    dev = q.device
    q_pos = pos0 + torch.arange(sr, device=dev) // r  # [SR]
    m = torch.full((b, kv, sr, 1), NEG_INF, device=dev)
    lsum = torch.zeros((b, kv, sr, 1), device=dev)
    acc = torch.zeros((b, kv, sr, d), device=dev)
    scale = d**-0.5
    for l0 in range(0, l, KERNEL_L_BLK):
        l1 = min(l, l0 + KERNEL_L_BLK)
        sc = qf @ kt[:, :, l0:l1].float().transpose(-1, -2) * scale  # [B, KV, SR, lb]
        l_pos = torch.arange(l0, l1, device=dev)
        keep = q_pos[:, None] >= l_pos[None, :]
        if window:
            keep &= (q_pos[:, None] - l_pos[None, :]) < window
        keep = keep[None, None]
        if kv_valid is not None:
            keep = keep & kv_valid[:, None, None, l0:l1]
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(sc - m_new), torch.zeros_like(sc))
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(vt.dtype).float() @ vt[:, :, l0:l1].float()
        m = m_new
    out = (acc / lsum.clamp_min(1e-20)).to(q.dtype)
    return out.reshape(b, kv, s, r, d).permute(0, 2, 1, 3, 4).reshape(b, s, h, d)


def _lib():
    fn = _build.load("flash_gqa_cache").kkv_flash_gqa_cache
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_gqa_cache(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0: int,
    kv_valid: Optional[torch.Tensor],
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Flash attention of ``q [B, S, H, D]`` over the head-major cache
    ``k, v [B, KV, L, D]``. A CPU tensor takes
    :func:`flash_gqa_cache_reference`; a CUDA tensor launches the kernel or
    raises. The card takes a bf16 ``q``, a bf16 cache or an int8 cache with
    f32 ``k_scale``/``v_scale`` [B, KV, L], D ∈ {64, 128} and any L.
    ``flash_gqa_cache.launches`` counts bf16-cache launches,
    ``flash_gqa_cache.launches_kv8`` int8-cache launches."""
    if q.device.type == "cpu":
        return flash_gqa_cache_reference(
            q, k, v, pos0, kv_valid, k_scale=k_scale, v_scale=v_scale, window=window
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_cache: unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape != v.shape or k.shape[3] != d:
        raise ValueError(f"flash_gqa_cache: k/v must be [B, KV, L, {d}], got {tuple(k.shape)}")
    kv, l = k.shape[1], k.shape[2]
    kv8 = k_scale is not None
    if q.dtype != torch.bfloat16:
        raise ValueError(
            f"flash_gqa_cache: the card runs bf16 models (q is {q.dtype}); "
            "a float32 model on the card is not ported"
        )
    if d not in (64, 128) or h % kv or l < 1 or window < 0:
        raise ValueError(f"flash_gqa_cache: unsupported layout H={h} KV={kv} L={l} D={d}")
    want = torch.int8 if kv8 else torch.bfloat16
    if k.dtype != want or v.dtype != want or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"flash_gqa_cache: k/v must be contiguous {want}")
    if kv8:
        for sc in (k_scale, v_scale):
            if sc is None or sc.shape != (b, kv, l) or sc.dtype != torch.float32 or not sc.is_contiguous():
                raise ValueError("flash_gqa_cache: k_scale/v_scale must be contiguous f32 [B, KV, L]")
    elif v_scale is not None:
        raise ValueError("flash_gqa_cache: v_scale without k_scale")
    if kv_valid is not None and (
        kv_valid.shape != (b, l) or kv_valid.dtype != torch.bool or not kv_valid.is_contiguous()
    ):
        raise ValueError("flash_gqa_cache: kv_valid must be a contiguous bool [B, L] tensor")
    tensors = [k, v] + ([k_scale, v_scale] if kv8 else []) + ([kv_valid] if kv_valid is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_gqa_cache: all tensors must be on one device")
    r = h // kv
    sr = s * r
    qf = q.reshape(b, s, kv, r, d).permute(0, 2, 1, 3, 4).reshape(b * kv, sr, d).contiguous()
    out = torch.empty((b * kv, sr, d), dtype=torch.bfloat16, device=q.device)
    if any(t.data_ptr() % 16 for t in (qf, out, k, v)):
        raise ValueError("flash_gqa_cache: tensors must be 16-byte aligned")
    fn = _lib()
    with torch.cuda.device(q.device):
        rc = fn(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
            kv_valid.view(torch.uint8).data_ptr() if kv_valid is not None else None,
            out.data_ptr(), b * kv, kv, sr, r, l, d, int(pos0), int(window), d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_gqa_cache kernel launch failed: cudaError {rc}")
    if kv8:
        flash_gqa_cache.launches_kv8 += 1
    else:
        flash_gqa_cache.launches += 1
    return out.reshape(b, kv, s, r, d).permute(0, 2, 1, 3, 4).reshape(b, s, h, d)


flash_gqa_cache.launches = 0
flash_gqa_cache.launches_kv8 = 0


def gqa_cache_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0: int,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    full_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cached GQA attention: the flash kernel for every shape it takes (on
    the card there is no profitability gate — ``_flash_wins`` was measured
    on a TPU); softcap and ``full_mask`` take :func:`gqa_grouped`, on the
    CPU only. ``window`` > 0 is sliding-window attention."""
    if full_mask is not None or softcap:
        if q.device.type == "cuda":
            raise NotImplementedError(
                "softcap / full_mask attention is not ported to the card yet"
            )
        if k_scale is not None:
            k = k.to(q.dtype) * k_scale.to(q.dtype)[..., None]
            v = v.to(q.dtype) * v_scale.to(q.dtype)[..., None]
        return gqa_grouped(q, k, v, pos0, kv_valid, window=window, softcap=softcap, full_mask=full_mask)
    return flash_gqa_cache(q, k, v, pos0, kv_valid, k_scale=k_scale, v_scale=v_scale, window=window)
