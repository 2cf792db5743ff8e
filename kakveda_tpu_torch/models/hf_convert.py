"""HF checkpoint → the port's Llama params (eight model families).

Counterpart of ``kakveda_tpu/models/hf_convert.py``: point
``KAKVEDA_HF_CKPT`` at a local HF-format checkpoint directory of a
supported family — Llama, Mistral, Qwen2, Qwen3, Gemma, Gemma-2, Phi-3,
Mixtral — and ``LlamaRuntime.from_env`` serves it (``KAKVEDA_HF_CKPTS``
serves several, ``models/runtime.MultiModelRuntime``). Every family delta
is a flag on :class:`LlamaConfig` (:func:`hf_config_to_llama`, with the
reference's refusals and messages).

Conversion, as the reference does it:

* HF ``nn.Linear`` stores ``[out, in]``; the port's matmuls are ``x @ W``
  with ``W [in, out]``, so every projection transposes. HF's split-half
  RoPE is the port's, so q/k need no permutation.
* Phi-3's fused ``qkv_proj`` / ``gate_up_proj`` split into the separate
  projections; Mixtral's per-expert ``w1``/``w2``/``w3`` stack into
  ``[E, ...]``.
* Gemma's (1 + w) RMSNorm gains are materialized and kept in f32 (bf16
  spacing near 1.0 is 2^-8); every other tensor is cast to
  ``param_dtype``, the q/k norms and other norms included.
* ``tie_word_embeddings`` (Gemma's default) makes ``lm_head`` a transposed
  copy of the embedding; a vocabulary that is not a multiple of 8 is padded
  with zero rows and ``cfg.effective_vocab`` masks the pad logits.

Tensors stream one at a time: each is read, converted and moved to
``device`` before the next is read. ``.safetensors`` files are read here
(an 8-byte little-endian header length, a JSON header of dtype, shape and
byte range per tensor, then the raw little-endian data), so no
``safetensors`` package is needed; ``.bin`` files go through
``torch.load(weights_only=True)``. The card is one device: there is no
``shard_params``.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from kakveda_tpu_torch.models.llama import LlamaConfig, Params
from kakveda_tpu_torch.ops.device import resolve_device

__all__ = ["hf_config_to_llama", "load_hf_checkpoint", "read_safetensors"]

_VOCAB_MULTIPLE = 8

_SUPPORTED_FAMILIES = (
    "llama", "mistral", "qwen2", "qwen3", "mixtral", "gemma", "gemma2", "phi3",
)
_GEMMA_FAMILIES = ("gemma", "gemma2")


def hf_config_to_llama(hf: Dict[str, Any], *, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Map an HF ``config.json`` dict to :class:`LlamaConfig`, as the
    reference does: ``llama``; ``mistral`` (a sliding window, an explicit
    head_dim); ``qwen2`` (q/k/v biases); ``qwen3`` (per-head q/k norms);
    ``mixtral`` (the sparse-MoE MLP); ``gemma`` (GeGLU, the sqrt(d_model)
    embedding scale, an explicit head_dim, 1 + w norms materialized at
    conversion); ``gemma2`` (gemma plus the alternating window, softcaps,
    the query scale and sandwich norms); ``phi3`` (fused projections,
    longrope). Anything else raises ``ValueError``, as do a rope scaling it
    does not know, Qwen2's mixed full/sliding layers and a Gemma-2
    ``layer_types`` that is not the even-slide alternation."""
    family = hf.get("model_type") or "llama"
    if family not in _SUPPORTED_FAMILIES:
        raise ValueError(
            f"unsupported model_type={family!r} (supported: {', '.join(_SUPPORTED_FAMILIES)})"
        )
    rope = hf.get("rope_scaling") or {}
    kw: Dict[str, Any] = {}
    if rope:
        rtype = rope.get("rope_type") or rope.get("type")
        if rtype == "llama3":
            kw = dict(
                rope_factor=float(rope["factor"]),
                rope_low_freq_factor=float(rope.get("low_freq_factor", 1.0)),
                rope_high_freq_factor=float(rope.get("high_freq_factor", 4.0)),
                rope_original_max_len=int(rope.get("original_max_position_embeddings", 8192)),
            )
        elif rtype == "longrope" and family == "phi3":
            # Per-dim divisors picked at run time (short while a row fits the
            # original context, long past it); the cos/sin scale is static.
            orig = int(hf.get("original_max_position_embeddings") or hf.get("max_position_embeddings"))
            maxp = int(hf.get("max_position_embeddings", orig))
            scale = maxp / orig
            if rope.get("attention_factor") is not None:
                attn_scale = float(rope["attention_factor"])
            else:
                attn_scale = math.sqrt(1.0 + math.log(scale) / math.log(orig)) if scale > 1.0 else 1.0
            hd_half = int(hf.get("head_dim") or int(hf["hidden_size"]) // int(hf["num_attention_heads"])) // 2
            short = tuple(float(f) for f in rope["short_factor"])
            long = tuple(float(f) for f in rope["long_factor"])
            if len(short) != hd_half or len(long) != hd_half:
                raise ValueError(
                    f"longrope factor lists must have head_dim//2={hd_half} entries "
                    f"(got {len(short)}/{len(long)})"
                )
            kw = dict(
                rope_dim_factors=short,
                rope_dim_factors_long=long,
                rope_original_max_len=orig,
                rope_attn_scaling=attn_scale,
            )
        else:
            raise ValueError(f"unsupported rope_scaling type: {rtype!r} (llama3; longrope for phi3)")

    # Mistral slides whenever the config sets a window; Qwen2/Qwen3 only
    # under use_sliding_window and past max_window_layers (default 28, as
    # Qwen2Config's), and only the uniform cases map here.
    window = int(hf.get("sliding_window") or 0)
    if family in ("qwen2", "qwen3") and window:
        if not hf.get("use_sliding_window", False):
            window = 0
        else:
            mwl = int(hf.get("max_window_layers", 28))
            if mwl >= int(hf["num_hidden_layers"]):
                window = 0
            elif mwl != 0:
                raise ValueError(
                    "qwen2 mixed full/sliding layers (0 < max_window_layers < "
                    "num_hidden_layers) is not supported"
                )

    n_heads = int(hf["num_attention_heads"])
    head_dim = int(hf.get("head_dim") or 0)
    if head_dim and head_dim * n_heads == int(hf["hidden_size"]):
        head_dim = 0  # the derived value: keep the config canonical

    fam_kw: Dict[str, Any] = {}
    if family == "mixtral":
        fam_kw = dict(
            n_experts=int(hf["num_local_experts"]),
            n_experts_per_tok=int(hf.get("num_experts_per_tok", 2)),
            router_aux_coef=float(hf.get("router_aux_loss_coef", 0.0)),
        )
    if family == "gemma2":
        hd_real = head_dim or int(hf["hidden_size"]) // n_heads
        qpas = float(hf.get("query_pre_attn_scalar") or 0.0)
        qs = qpas**-0.5 if qpas else 0.0
        if qs and abs(qs - hd_real**-0.5) < 1e-12:
            qs = 0.0  # the default head_dim scale: keep the config canonical
        lt = hf.get("layer_types")
        if lt is not None and window:
            want = [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(int(hf["num_hidden_layers"]))
            ]
            if list(lt) != want:
                raise ValueError(
                    "gemma2 layer_types deviates from the even-slide/odd-full "
                    "alternation; this pattern is not supported"
                )
        fam_kw.update(
            alt_window=window > 0,
            attn_softcap=float(hf.get("attn_logit_softcapping") or 0.0),
            final_softcap=float(hf.get("final_logit_softcapping") or 0.0),
            query_scale=qs,
            post_norms=True,
        )

    vocab = int(hf["vocab_size"])
    padded = -(-vocab // _VOCAB_MULTIPLE) * _VOCAB_MULTIPLE
    return LlamaConfig(
        **fam_kw,
        vocab_size=padded,
        effective_vocab=vocab if padded != vocab else None,
        d_model=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads", n_heads)),
        d_ff=int(hf["intermediate_size"]),
        max_seq_len=int(hf.get("max_position_embeddings", 2048)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        dtype=dtype,
        attn_bias=bool(hf.get("attention_bias", family == "qwen2")),
        qk_norm=family == "qwen3",
        sliding_window=window,
        head_dim_opt=head_dim,
        act_fn="gelu_tanh" if family in _GEMMA_FAMILIES else "silu",
        scale_embed=family in _GEMMA_FAMILIES,
        **kw,
    )


# ---------------------------------------------------------------------------
# tensor streaming
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for each tensor of a ``.safetensors`` file, in the
    order of their bytes, one read at a time. The format: an unsigned
    64-bit little-endian header length, a JSON header mapping each name to
    its ``dtype``, ``shape`` and ``data_offsets`` [begin, end) (from the end
    of the header; ``__metadata__`` is skipped), then the data,
    little-endian."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name, meta in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            dt = _ST_DTYPES.get(meta["dtype"])
            if dt is None:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {meta['dtype']!r}")
            begin, end = meta["data_offsets"]
            f.seek(8 + n + begin)
            buf = bytearray(f.read(end - begin))
            shape = tuple(meta["shape"])
            if len(buf) != math.prod(shape) * dt.itemsize:
                raise ValueError(f"{path}: tensor {name} holds {len(buf)} bytes for shape {shape}")
            t = torch.frombuffer(buf, dtype=dt) if buf else torch.empty(0, dtype=dt)
            yield name, t.reshape(shape)


def _iter_weight_files(path: str) -> Iterator[str]:
    """Checkpoint shard files, index-ordered when an index exists."""
    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(path, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            for fn in files:
                yield os.path.join(path, fn)
            return
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            yield p
            return
    raise FileNotFoundError(f"no model weights (safetensors or bin) under {path}")


def _tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, float32 CPU tensor) one at a time across all shards."""
    for fn in _iter_weight_files(path):
        if fn.endswith(".safetensors"):
            for name, t in read_safetensors(fn):
                yield name, t.float()
        else:
            for name, t in torch.load(fn, map_location="cpu", weights_only=True).items():
                yield name, t.float()


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def _empty_tree(cfg: LlamaConfig) -> Params:
    keys = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    keys += ["router", "we_gate", "we_up", "we_down"] if cfg.n_experts else ["w_gate", "w_up", "w_down"]
    if cfg.attn_bias:
        keys += ["bq", "bk", "bv"]
    if cfg.post_norms:
        keys += ["post_attn_norm", "post_ffw_norm"]
    if cfg.qk_norm:
        keys += ["q_norm", "k_norm"]
    return {
        "embed": None,
        "layers": [{k: None for k in keys} for _ in range(cfg.n_layers)],
        "final_norm": None,
        "lm_head": None,
    }


def _pad_vocab_rows(t: torch.Tensor, padded: int) -> torch.Tensor:
    if t.shape[0] == padded:
        return t
    out = torch.zeros((padded,) + tuple(t.shape[1:]), dtype=t.dtype)
    out[: t.shape[0]] = t
    return out


def load_hf_checkpoint(
    path: str,
    *,
    param_dtype: torch.dtype = torch.bfloat16,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Tuple[Params, LlamaConfig]:
    """Load and convert an HF checkpoint directory onto ``device`` (the card
    unless named). Returns (params, cfg): tensors in ``param_dtype`` but
    Gemma's f32 norm gains; ``compute_dtype`` (default ``param_dtype``)
    becomes ``cfg.dtype``. The same leaves, in value and dtype, as the
    reference's loader."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = hf_config_to_llama(hf_cfg, dtype=compute_dtype or param_dtype)
    is_gemma = hf_cfg.get("model_type") in _GEMMA_FAMILIES
    norm_off = 1.0 if is_gemma else 0.0
    norm_dtype = torch.float32 if is_gemma else None

    params = _empty_tree(cfg)
    staged: Dict[Tuple[int, str], list] = {}  # Mixtral experts, stacked per layer at the end

    def conv(t: torch.Tensor, transpose: bool, dtype=None) -> torch.Tensor:
        t = t.to(dtype or param_dtype)
        return (t.T if transpose else t).contiguous().to(dev)

    def put(slot, key: str, t: torch.Tensor, *, transpose: bool, dtype=None) -> None:
        slot[key] = conv(t, transpose, dtype)

    def put_norm(slot, key: str, t: torch.Tensor) -> None:
        put(slot, key, t + norm_off, transpose=False, dtype=norm_dtype)

    def stage_expert(li: int, key: str, ei: int, t: torch.Tensor) -> None:
        lst = staged.setdefault((li, key), [None] * cfg.n_experts)
        if not 0 <= ei < cfg.n_experts:
            raise ValueError(f"expert index {ei} out of range (n_experts={cfg.n_experts})")
        lst[ei] = conv(t, True)

    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    for name, t in _tensors(path):
        base = name.removeprefix("model.")
        if base == "embed_tokens.weight":
            put(params, "embed", _pad_vocab_rows(t, cfg.vocab_size), transpose=False)
        elif base == "norm.weight":
            put_norm(params, "final_norm", t)
        elif name == "lm_head.weight":
            put(params, "lm_head", _pad_vocab_rows(t, cfg.vocab_size), transpose=True)
        elif base.startswith("layers."):
            _, idx, rest = base.split(".", 2)
            layer = params["layers"][int(idx)]
            if rest == "input_layernorm.weight":
                put_norm(layer, "attn_norm", t)
            elif rest == "post_attention_layernorm.weight":
                # Gemma-2's is a sandwich norm on the attention output;
                # everywhere else it is the pre-MLP norm.
                put_norm(layer, "post_attn_norm" if cfg.post_norms else "mlp_norm", t)
            elif rest == "pre_feedforward_layernorm.weight":
                put_norm(layer, "mlp_norm", t)
            elif rest == "post_feedforward_layernorm.weight":
                put_norm(layer, "post_ffw_norm", t)
            elif rest in ("self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
                          "self_attn.o_proj.weight"):
                put(layer, "w" + rest.split(".")[1][0], t, transpose=True)
            elif rest in ("self_attn.q_proj.bias", "self_attn.k_proj.bias", "self_attn.v_proj.bias"):
                if not cfg.attn_bias:
                    raise ValueError(f"checkpoint carries {name} but the config resolved attn_bias=False")
                put(layer, "b" + rest.split(".")[1][0], t, transpose=False)
            elif rest in ("mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight"):
                put(layer, "w_" + rest.split(".")[1].removesuffix("_proj"), t, transpose=True)
            elif rest in ("self_attn.q_norm.weight", "self_attn.k_norm.weight"):
                put(layer, rest.split(".")[1], t, transpose=False)
            elif rest == "self_attn.qkv_proj.weight":  # Phi-3: [nq + 2 nkv, d_model]
                put(layer, "wq", t[:nq], transpose=True)
                put(layer, "wk", t[nq : nq + nkv], transpose=True)
                put(layer, "wv", t[nq + nkv :], transpose=True)
            elif rest == "mlp.gate_up_proj.weight":  # Phi-3: [2 d_ff, d_model]
                put(layer, "w_gate", t[: cfg.d_ff], transpose=True)
                put(layer, "w_up", t[cfg.d_ff :], transpose=True)
            elif rest == "self_attn.rotary_emb.inv_freq":
                pass  # derived, not a parameter
            elif rest == "block_sparse_moe.gate.weight":
                put(layer, "router", t, transpose=True)
            elif rest.startswith("block_sparse_moe.experts."):
                # experts.{i}.w1|w2|w3.weight: w1 = gate, w2 = down, w3 = up
                parts = rest.split(".")
                ei, proj = int(parts[2]), parts[3]
                key = {"w1": "we_gate", "w2": "we_down", "w3": "we_up"}.get(proj)
                if key is None or parts[4:] != ["weight"]:
                    raise ValueError(f"unrecognized expert tensor: {name}")
                stage_expert(int(idx), key, ei, t)
            else:
                raise ValueError(f"unrecognized layer tensor: {name}")
        elif name.endswith("rotary_emb.inv_freq"):
            pass
        else:
            raise ValueError(f"unrecognized tensor: {name}")

    for (li, key), lst in staged.items():
        holes = [i for i, a in enumerate(lst) if a is None]
        if holes:
            raise ValueError(f"layer {li} {key}: missing experts {holes[:8]}")
        params["layers"][li][key] = torch.stack(lst)

    if params["lm_head"] is None:
        # Gemma ties by class default and omits the key from config.json.
        if not hf_cfg.get("tie_word_embeddings", is_gemma):
            raise ValueError("checkpoint has no lm_head and tie_word_embeddings is false")
        if params["embed"] is not None:
            params["lm_head"] = params["embed"].T.contiguous()

    missing = [k for k in ("embed", "final_norm") if params[k] is None] + [
        f"layers.{i}.{k}" for i, layer in enumerate(params["layers"]) for k, v in layer.items() if v is None
    ]
    if missing:
        raise ValueError(f"checkpoint missing tensors for: {missing[:8]}{'…' if len(missing) > 8 else ''}")
    return params, cfg
