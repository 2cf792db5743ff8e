"""Weight-only int8 quantization for the serving path.

Counterpart of ``kakveda_tpu/models/quant.py``, bit for bit on the same f32
input. A quantized dense weight is the leaf pair ``{"q": int8 [in, out],
"s": f32 [out]}`` (stacked MoE experts: ``q [E, in, out]``, ``s [E, out]``);
``llama.wmat`` materializes either form at compute dtype, so the forward and
decode code do not fork on it. RMSNorm gains, the MoE router and the
embedding stay as they are.

On the card the dequantize is a separate elementwise pass in front of each
matmul (``wmat``): the weights sit in device memory at int8 width, but every
forward reads them and writes and reads a bf16 copy. A GEMM that dequantizes
in registers is later work.

Enable with ``LlamaRuntime(..., quant="int8")`` or ``KAKVEDA_QUANT=int8``.
Inference only.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_DENSE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "we_gate", "we_up", "we_down")


def quantize_tensor_int8(w: torch.Tensor, *, consume: bool = False) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel (last axis) int8: ``s = absmax / 127``
    per output column over the contraction axis (1.0 where a column is all
    zero), ``q = clip(round(w / s), -127, 127)`` with round-half-to-even.
    2-D ``[in, out]`` gives ``s [out]``; stacked ``[E, in, out]`` gives
    ``s [E, out]``. Computed on ``w``'s device, in f32. ``consume=True``
    divides an f32 ``w`` in place (its values are lost), so quantizing a
    fresh draw holds no second f32 copy."""
    w32 = w.float()
    absmax = torch.maximum(w32.amax(dim=-2), -w32.amin(dim=-2))
    # A tensor divisor: CUDA multiplies by the reciprocal of a Python-scalar
    # divisor, which is not IEEE division and breaks bit parity.
    s = absmax / torch.full_like(absmax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    owned = consume or w32 is not w  # an f32 copy of a bf16 w is ours too
    r = w32.div_(s[..., None, :]) if owned else w32 / s[..., None, :]
    q = r.round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every dense projection (the stacked MoE experts included)
    and ``lm_head``; keep norms, the router and the embedding. Leaves that
    are already ``{"q", "s"}`` pairs are kept as they are."""

    def quant(w):
        return w if isinstance(w, dict) else quantize_tensor_int8(w)

    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "lm_head": quant(params["lm_head"]),
        "layers": [
            {k: quant(v) if k in _DENSE_KEYS else v for k, v in layer.items()}
            for layer in params["layers"]
        ],
    }


def quantization_error(params: Dict[str, Any], qparams: Dict[str, Any]) -> float:
    """Largest relative reconstruction error of a dense layer weight,
    ``max|w - q·s| / max|w|`` per tensor (a diagnostic)."""
    worst = 0.0
    for orig, quant in zip(params["layers"], qparams["layers"]):
        for k in _DENSE_KEYS:
            if k not in orig:
                continue
            w = orig[k].float()
            wq = quant[k]["q"].float() * quant[k]["s"][..., None, :]
            worst = max(worst, ((w - wq).abs().amax() / w.abs().amax()).item())
    return worst
