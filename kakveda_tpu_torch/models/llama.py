"""In-tree Llama: config, parameters, blocks and the KV-cache decode step.

Counterpart of ``kakveda_tpu/models/llama.py`` for Llama-family models
with a dense or a sparse-MoE MLP (Llama, Mistral's sliding window, Mixtral's
experts in ``models/moe.py``, Gemma-2's softcaps). Plain functions on
tensors: params are a dict with the JAX package's keys and layouts (``x @
W`` with ``W [in, out]``), matrices stored in ``cfg.dtype`` or as int8
weight-only ``{"q", "s"}`` pairs (``models/quant.py``), the MoE router and
norm gains in f32 (so ``rms_norm`` takes its f32-gain branch under bf16, as
the JAX runtime does with its f32 params). The cache is updated in place,
where the JAX version returns a new one.

Not ported yet (``convert.llama_params_from_jax`` refuses their params):
the other family flags (biases, GeGLU, embedding scale, query scale,
sandwich and q/k norms, Gemma-2's alternating window, Phi-3 longrope), the
MoE load-balancing loss, and the full-sequence ``forward``, ring attention
and training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kakveda_tpu_torch.models.attention import gqa_cache_attention
from kakveda_tpu_torch.models.quant import _DENSE_KEYS, quantize_tensor_int8
from kakveda_tpu_torch.ops.device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 264  # ByteTokenizer's 259, padded to a multiple of 8
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1024
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Llama-3.1-style NTK rope scaling; factor 1.0 means off.
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    # Real tokenizer vocab when the table is padded past it (sampling masks
    # the columns beyond); None = no padding.
    effective_vocab: Optional[int] = None
    # Sliding attention window in tokens (Mistral; 0 = full causal) and the
    # Gemma-2 tanh softcaps of attention scores and final logits (0 = off;
    # attention softcap runs on the CPU only so far).
    sliding_window: int = 0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # KV-cache quantization ("" | "int8"): int8 rows + per-row f32 scales.
    kv_quant: str = ""
    # Sparse-MoE MLP (Mixtral; models/moe.py): 0 experts means dense. A
    # capacity factor <= 0 means no-drop dispatch, a positive one caps each
    # expert at ceil(T·k/E·factor) tokens. router_aux_coef is carried for
    # the training objective, which is not ported.
    n_experts: int = 0
    n_experts_per_tok: int = 2
    expert_capacity_factor: float = 0.0
    router_aux_coef: float = 0.0

    def layer_window(self, li: int) -> int:
        """Effective sliding window for layer ``li`` (0 = full causal)."""
        return self.sliding_window

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, vocab_size: int = 128256) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
            max_seq_len=8192,
            rope_theta=500000.0,
        )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: LlamaConfig, device=None, quant: Optional[str] = None) -> Params:
    """Random weights with the JAX package's distribution: N(0, 1) / √fan_in
    per matrix, ones for norm gains; MoE layers (``cfg.n_experts``) carry a
    ``router [D, E]`` and stacked ``we_gate`` / ``we_up [E, D, F]``,
    ``we_down [E, F, D]`` in place of the dense MLP. Each matrix is drawn in
    f32 on ``device`` and cast to ``cfg.dtype`` (the router stays f32) or,
    with ``quant="int8"``, quantized as the JAX package quantizes its f32
    params, before the next is drawn: no f32 copy of the whole model, and
    no bf16 one under int8, is ever held. ``generator`` must live on
    ``device``; its draws differ from ``jax.random`` by design (carry JAX
    weights across with ``convert.llama_params_from_jax``)."""
    if quant not in (None, "none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (int8|none)")
    dev = resolve_device(device)
    hd = cfg.head_dim

    def draw(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in))

    def dense(name, fan_in, shape):
        if quant == "int8" and (name in _DENSE_KEYS or name == "lm_head"):
            return quantize_tensor_int8(draw(fan_in, shape), consume=True)
        if name == "router":
            return draw(fan_in, shape)
        return draw(fan_in, shape).to(cfg.dtype)

    def gain(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": gain(d),
            "wq": dense("wq", d, (d, cfg.n_heads * hd)),
            "wk": dense("wk", d, (d, cfg.n_kv_heads * hd)),
            "wv": dense("wv", d, (d, cfg.n_kv_heads * hd)),
            "wo": dense("wo", cfg.n_heads * hd, (cfg.n_heads * hd, d)),
            "mlp_norm": gain(d),
        }
        if e:
            layer["router"] = dense("router", d, (d, e))
            layer["we_gate"] = dense("we_gate", d, (e, d, f))
            layer["we_up"] = dense("we_up", d, (e, d, f))
            layer["we_down"] = dense("we_down", f, (e, f, d))
        else:
            layer["w_gate"] = dense("w_gate", d, (d, f))
            layer["w_up"] = dense("w_up", d, (d, f))
            layer["w_down"] = dense("w_down", f, (f, d))
        layers.append(layer)
    return {
        "embed": dense("embed", d, (cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": gain(d),
        "lm_head": dense("lm_head", d, (d, cfg.vocab_size)),
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def wmat(w, dt: torch.dtype) -> torch.Tensor:
    """A weight at compute dtype: a tensor (no copy when it is stored so),
    or an int8 ``{"q", "s"}`` pair dequantized as the JAX package does it,
    the scale cast to ``dt`` first and the product rounded in ``dt``. 2-D
    and stacked ``[E, in, out]`` alike (the scale broadcasts over ``in``)."""
    if isinstance(w, dict):
        return w["q"].to(dt) * w["s"].to(dt)[..., None, :]
    return w.to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if w.dtype == torch.float32 and x.dtype != torch.float32:
        # f32 gains under a low-precision compute dtype apply in f32 before
        # the downcast (the JAX runtime's branch for its f32 gains).
        return ((x32 * scale) * w).to(x.dtype)
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


def _rope_freqs(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] for ``positions``, with Llama-3.1's
    wavelength-dependent NTK scaling when ``rope_factor`` > 1."""
    half = cfg.head_dim // 2
    inv = 1.0 / (
        cfg.rope_theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    )
    if cfg.rope_factor != 1.0:
        wavelen = 2.0 * math.pi / inv
        low_wl = cfg.rope_original_max_len / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_len / cfg.rope_high_freq_factor
        smooth = (cfg.rope_original_max_len / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        blended = (1.0 - smooth) * inv / cfg.rope_factor + smooth * inv
        inv = torch.where(
            wavelen > low_wl, inv / cfg.rope_factor, torch.where(wavelen < high_wl, inv, blended)
        )
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] broadcast over heads, cast to
    the activation dtype before the products."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def qkv_proj(h: torch.Tensor, layer: Params, cfg: LlamaConfig, dt: torch.dtype):
    """q/k/v projections: h [B, S, d_model] -> q [B, S, H, hd], k/v
    [B, S, KV, hd]."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = (h @ wmat(layer["wq"], dt)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ wmat(layer["wk"], dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ wmat(layer["wv"], dt)).reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def mask_pad_vocab(logits: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """−inf the padded vocab columns of ``[..., V]`` logits, in place; returns
    them. Identity when the vocab is not padded."""
    if cfg.effective_vocab is not None:
        logits[..., cfg.effective_vocab :] = float("-inf")
    return logits


def softcap_logits(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """cap·tanh(x/cap); identity at cap = 0."""
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


def embed_tokens(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding at compute dtype."""
    return F.embedding(tokens, params["embed"].to(cfg.dtype))


def mlp_block(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """Dense SwiGLU, or the sparse-MoE MLP for a layer that carries a
    ``router`` (``models/moe.py``)."""
    if "router" in layer:
        from kakveda_tpu_torch.models.moe import moe_mlp

        return moe_mlp(x, layer, cfg)
    dt = x.dtype
    g = F.silu(x @ wmat(layer["w_gate"], dt))
    return (g * (x @ wmat(layer["w_up"], dt))) @ wmat(layer["w_down"], dt)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None, device=None) -> Params:
    """Per-layer head-major K/V buffers [B, KV, max_len, hd] (each kv head's
    rows contiguous, the layout the flash kernel streams), zeroed. Under
    ``kv_quant == "int8"`` the buffers are int8 with per-row f32 scales
    ``ks``/``vs`` [B, KV, max_len]. ``pos`` is a Python int."""
    dev = resolve_device(device)
    ml = max_len or cfg.max_seq_len
    shape = (batch, cfg.n_kv_heads, ml, cfg.head_dim)
    n = cfg.n_layers
    if cfg.kv_quant == "int8":
        return {
            "pos": 0,
            "k": [torch.zeros(shape, dtype=torch.int8, device=dev) for _ in range(n)],
            "v": [torch.zeros(shape, dtype=torch.int8, device=dev) for _ in range(n)],
            "ks": [torch.zeros(shape[:3], dtype=torch.float32, device=dev) for _ in range(n)],
            "vs": [torch.zeros(shape[:3], dtype=torch.float32, device=dev) for _ in range(n)],
        }
    if cfg.kv_quant:
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r} (int8 or empty)")
    return {
        "pos": 0,
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(n)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(n)],
    }


def _kv_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of K/V rows [..., hd]: (int8
    values, f32 scales [...]) with x ≈ q · scale."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1) / 127.0
    safe = s.clamp_min(1e-8)[..., None]
    q = torch.clamp(torch.round(x32 / safe), -127, 127).to(torch.int8)
    return q, s


def _kv_dequant(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_kv_quant_rows`: the scale is cast to ``dtype``
    first and the product taken in ``dtype``."""
    return q.to(dtype) * s[..., None].to(dtype)


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int64 — prompt chunk or single sampled token
    cache: Params,
    kv_valid: Optional[torch.Tensor] = None,  # [B, max_len] — False masks pad slots
    pos_offset: Optional[torch.Tensor] = None,  # [B] — logical-position shift (left pad)
    last_only: bool = False,
) -> Tuple[torch.Tensor, Params]:
    """Incremental forward with KV cache: writes this chunk's K/V rows at
    ``cache["pos"]`` (in place), attends through :func:`gqa_cache_attention`
    and returns (logits [B, S or 1, V] f32, cache). ``kv_valid``/``pos_offset``
    give exact left-padded batching (RoPE positions are slot − offset);
    ``last_only`` computes the final norm and vocab projection for the last
    position only."""
    b, s = tokens.shape
    pos0 = int(cache["pos"])
    ml = cache["k"][0].shape[2]
    if pos0 + s > ml:
        raise ValueError(f"decode_step: {pos0} + {s} rows overrun the cache window {ml}")
    positions = (torch.arange(s, device=tokens.device) + pos0).expand(b, s)
    if pos_offset is not None:
        positions = positions - pos_offset[:, None]
    cos, sin = _rope_freqs(cfg, positions)
    hd = cfg.head_dim
    kq = cfg.kv_quant == "int8"

    x = embed_tokens(params, cfg, tokens)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        dt = h.dtype
        q, k, v = qkv_proj(h, layer, cfg, dt)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_rows = k.transpose(1, 2)  # [B, KV, S, D]
        v_rows = v.transpose(1, 2)
        ks = vs = None
        if kq:
            k_i8, k_sc = _kv_quant_rows(k_rows)
            v_i8, v_sc = _kv_quant_rows(v_rows)
            cache["k"][li][:, :, pos0 : pos0 + s] = k_i8
            cache["v"][li][:, :, pos0 : pos0 + s] = v_i8
            cache["ks"][li][:, :, pos0 : pos0 + s] = k_sc
            cache["vs"][li][:, :, pos0 : pos0 + s] = v_sc
            ks, vs = cache["ks"][li], cache["vs"][li]
        else:
            cache["k"][li][:, :, pos0 : pos0 + s] = k_rows
            cache["v"][li][:, :, pos0 : pos0 + s] = v_rows
        attn = gqa_cache_attention(
            q, cache["k"][li], cache["v"][li], pos0, kv_valid,
            window=cfg.layer_window(li), softcap=cfg.attn_softcap, k_scale=ks, v_scale=vs,
        )
        x = x + attn.reshape(b, s, cfg.n_heads * hd) @ wmat(layer["wo"], dt)
        x = x + mlp_block(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer, cfg)

    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wmat(params["lm_head"], cfg.dtype)).float()
    logits = softcap_logits(logits, cfg.final_softcap)
    cache["pos"] = pos0 + s
    return logits, cache
