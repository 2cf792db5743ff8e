"""In-tree Llama: config, parameters, blocks and the KV-cache decode step.

Counterpart of ``kakveda_tpu/models/llama.py``: one forward for the eight
HF families it serves (Llama, Mistral, Qwen2, Qwen3, Gemma, Gemma-2, Phi-3,
Mixtral), every family delta a flag on :class:`LlamaConfig`
(``models/hf_convert.py`` maps the checkpoints): q/k/v biases, an explicit
head_dim, GeGLU and the embedding scale, Gemma-2's alternating window,
softcaps, query scale and sandwich norms, Qwen3's q/k norms and Phi-3's
longrope. Plain functions on tensors: params are a dict with the JAX
package's keys and layouts (``x @ W`` with ``W [in, out]``), matrices stored
in ``cfg.dtype`` or as int8 weight-only ``{"q", "s"}`` pairs
(``models/quant.py``); norm gains, biases and the MoE router keep the dtype
they were given (``init_params`` draws them in f32, so ``rms_norm`` takes
its f32-gain branch under bf16, as the JAX runtime does with its f32
params). The cache is updated in place, where the JAX version returns a
new one.

Not ported yet: the MoE load-balancing loss, and the full-sequence
``forward``, ring attention and training.
"""

from __future__ import annotations

import dataclasses
import functools
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
    # Family knobs: q/k/v projection biases (Qwen2), a sliding attention
    # window in tokens (Mistral; 0 = full causal), an explicit head_dim
    # (0 = d_model // n_heads).
    attn_bias: bool = False
    sliding_window: int = 0
    head_dim_opt: int = 0
    # Gemma: tanh-GELU gate (GeGLU) and sqrt(d_model) embedding scale; its
    # (1 + w) RMSNorm gains are materialized at conversion.
    act_fn: str = "silu"  # "silu" | "gelu_tanh"
    scale_embed: bool = False
    # Gemma-2: the window on even layers only, tanh softcaps of attention
    # scores and final logits (0 = off), an explicit query scale (0 =
    # head_dim**-0.5) and sandwich norms inside each residual branch.
    alt_window: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: float = 0.0
    post_norms: bool = False
    # Qwen3: per-head q/k RMSNorm over head_dim, before RoPE.
    qk_norm: bool = False
    # Phi-3 longrope: per-dimension inverse-frequency divisors (head_dim/2
    # each), short while a row's sequence fits rope_original_max_len, long
    # past it (picked per row), and a static cos/sin scale.
    rope_dim_factors: tuple = ()
    rope_dim_factors_long: tuple = ()
    rope_attn_scaling: float = 1.0
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
        """Effective sliding window for layer ``li`` (0 = full causal): odd
        layers run full causal under ``alt_window``."""
        if not self.sliding_window or (self.alt_window and li % 2 == 1):
            return 0
        return self.sliding_window

    @property
    def head_dim(self) -> int:
        return self.head_dim_opt or self.d_model // self.n_heads

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
    per matrix, ones for norm gains, zeros for biases; MoE layers
    (``cfg.n_experts``) carry a ``router [D, E]`` and stacked ``we_gate`` /
    ``we_up [E, D, F]``, ``we_down [E, F, D]`` in place of the dense MLP, and
    the family flags add the JAX package's keys (``bq``/``bk``/``bv``,
    ``post_attn_norm``/``post_ffw_norm``, ``q_norm``/``k_norm`` [head_dim]),
    all f32. Each matrix is drawn in
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

    def bias(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

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
        if cfg.attn_bias:
            layer.update(bq=bias(cfg.n_heads * hd), bk=bias(cfg.n_kv_heads * hd), bv=bias(cfg.n_kv_heads * hd))
        if cfg.post_norms:
            layer.update(post_attn_norm=gain(d), post_ffw_norm=gain(d))
        if cfg.qk_norm:
            layer.update(q_norm=gain(hd), k_norm=gain(hd))
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


def _in_dtype(v: float, dt: torch.dtype) -> float:
    """``v`` rounded to ``dt`` on the host (``jnp.asarray(v, dt)`` in the
    JAX package): a Python float that multiplies a ``dt`` tensor exactly as
    a ``dt`` scalar does, with no host-to-device copy (a forward stays
    capturable in a CUDA graph)."""
    return torch.tensor(v, dtype=dt).item()


@functools.lru_cache(maxsize=32)
def _rope_divisors(factors: tuple, device: torch.device) -> torch.Tensor:
    """Longrope's per-dimension divisors on ``device``, made once (a copy
    from the host inside a CUDA-graph capture would fail)."""
    return torch.tensor(factors, dtype=torch.float32, device=device)


def _rope_freqs(
    cfg: LlamaConfig, positions: torch.Tensor, seq_len: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] for ``positions``, with Llama-3.1's
    wavelength-dependent NTK scaling when ``rope_factor`` > 1, or Phi-3's
    longrope divisors: short factors while a row's length (its largest
    position + 1, or ``seq_len`` [B], which chunked prefill passes so that
    every piece rotates as the whole prompt does) is at most
    ``rope_original_max_len``, long ones past it, picked per row."""
    dev = positions.device
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(half, dtype=torch.float32, device=dev) / half))
    if cfg.rope_dim_factors:
        inv_short = inv / _rope_divisors(cfg.rope_dim_factors, dev)
        if cfg.rope_dim_factors_long:
            inv_long = inv / _rope_divisors(cfg.rope_dim_factors_long, dev)
            if seq_len is None:
                eff_len = positions.amax(dim=-1, keepdim=True) + 1
            else:
                eff_len = torch.as_tensor(seq_len, device=dev).to(torch.int32)[..., None]
            long_row = eff_len > cfg.rope_original_max_len  # [..., 1]
            ang = positions[..., None].float()
            ang = torch.where(long_row[..., None], ang * inv_long, ang * inv_short)
            scale = cfg.rope_attn_scaling
            return torch.cos(ang) * scale, torch.sin(ang) * scale
        inv = inv_short
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
    if cfg.rope_attn_scaling != 1.0:
        return torch.cos(ang) * cfg.rope_attn_scaling, torch.sin(ang) * cfg.rope_attn_scaling
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
    [B, S, KV, hd]; then the biases (Qwen2), Qwen3's per-head q/k norms, and
    the explicit query scale folded into q. The fold comes after the norms,
    which would cancel a scale applied before them, and it commutes with
    RoPE (the kernel scales scores by head_dim**-0.5)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = h @ wmat(layer["wq"], dt)
    k = h @ wmat(layer["wk"], dt)
    v = h @ wmat(layer["wv"], dt)
    if "bq" in layer:
        q = q + layer["bq"].to(dt)
        k = k + layer["bk"].to(dt)
        v = v + layer["bv"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in layer:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    if cfg.query_scale:
        q = q * _in_dtype(cfg.query_scale * math.sqrt(hd), dt)
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
    """Token embedding at compute dtype; Gemma scales it by sqrt(d_model),
    the scale rounded to the compute dtype first."""
    x = F.embedding(tokens, params["embed"].to(cfg.dtype))
    if cfg.scale_embed:
        x = x * _in_dtype(math.sqrt(cfg.d_model), cfg.dtype)
    return x


def _act(x: torch.Tensor, act_fn: str) -> torch.Tensor:
    if act_fn == "gelu_tanh":  # Gemma's GeGLU gate
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_block(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """Dense SwiGLU (GeGLU under ``act_fn="gelu_tanh"``), or the sparse-MoE
    MLP for a layer that carries a ``router`` (``models/moe.py``)."""
    if "router" in layer:
        from kakveda_tpu_torch.models.moe import moe_mlp

        return moe_mlp(x, layer, cfg)
    dt = x.dtype
    g = _act(x @ wmat(layer["w_gate"], dt), cfg.act_fn)
    return (g * (x @ wmat(layer["w_up"], dt))) @ wmat(layer["w_down"], dt)


def attn_residual(x: torch.Tensor, attn: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """``x`` plus the attention branch (heads merged, ``wo`` applied), then
    the MLP branch; each branch goes through its sandwich norm (Gemma-2's
    ``post_attn_norm`` / ``post_ffw_norm``) when the layer has one."""
    b, s = x.shape[:2]
    a = attn.reshape(b, s, -1) @ wmat(layer["wo"], x.dtype)
    if "post_attn_norm" in layer:
        a = rms_norm(a, layer["post_attn_norm"], cfg.norm_eps)
    x = x + a
    m = mlp_block(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer, cfg)
    if "post_ffw_norm" in layer:
        m = rms_norm(m, layer["post_ffw_norm"], cfg.norm_eps)
    return x + m


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
    seq_total: Optional[torch.Tensor] = None,  # [B] — whole-prompt length for longrope
) -> Tuple[torch.Tensor, Params]:
    """Incremental forward with KV cache: writes this chunk's K/V rows at
    ``cache["pos"]`` (in place), attends through :func:`gqa_cache_attention`
    and returns (logits [B, S or 1, V] f32, cache). ``kv_valid``/``pos_offset``
    give exact left-padded batching (RoPE positions are slot − offset);
    ``last_only`` computes the final norm and vocab projection for the last
    position only; ``seq_total`` picks the longrope regime of each row from
    its whole prompt's length (chunked prefill must pass it; decode steps
    leave it None: the running length)."""
    b, s = tokens.shape
    pos0 = int(cache["pos"])
    ml = cache["k"][0].shape[2]
    if pos0 + s > ml:
        raise ValueError(f"decode_step: {pos0} + {s} rows overrun the cache window {ml}")
    positions = (torch.arange(s, device=tokens.device) + pos0).expand(b, s)
    if pos_offset is not None:
        positions = positions - pos_offset[:, None]
    cos, sin = _rope_freqs(cfg, positions, seq_total)
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
        x = attn_residual(x, attn, layer, cfg)

    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wmat(params["lm_head"], cfg.dtype)).float()
    logits = softcap_logits(logits, cfg.final_softcap)
    cache["pos"] = pos0 + s
    return logits, cache
