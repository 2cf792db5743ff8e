"""Carry JAX state across to the port: an index, and a Llama's weights.

``knn_state_from_jax`` takes the JAX ``ShardedKnn``'s buffers as numpy
arrays (``np.asarray`` of its ``emb``, ``valid`` and per-slot ``types``) and
returns the port's slot-ordered tensors: the JAX index places logical slot
``s`` on shard ``s % n`` at row ``s // n`` (round-robin), the port's
single-device index keeps slot ``s`` at row ``s``. Replaying a data dir the
JAX package wrote is the other half (``index/gfkb.py``).

``llama_params_from_jax`` takes the JAX Llama param tree as numpy arrays and
returns the port's.

``mine_projection_from_jax`` carries the mining sweep's projection across:
the JAX package draws its [d, 256] Gaussian from ``PRNGKey(7)``, a stream the
port cannot reproduce without jax, so a caller that needs the JAX partition
of the projection tier passes that matrix in (``projection=`` of
``ops/clustering.cluster_embeddings``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kakveda_tpu_torch.ops.device import resolve_device, store_dtype


def physical_to_slot(phys: np.ndarray, n_shards: int, rows_per_shard: int) -> np.ndarray:
    """Physical row of the sharded ``[capacity, d]`` array → logical slot."""
    return (phys % rows_per_shard) * n_shards + phys // rows_per_shard


def mine_projection_from_jax(r: np.ndarray, device: str | torch.device | None = None) -> torch.Tensor:
    """The JAX mining projection (``np.asarray`` of the un-scaled [d, out]
    Gaussian) as an f32 tensor on ``device``."""
    return torch.from_numpy(np.array(r, dtype=np.float32)).to(resolve_device(device))


def knn_state_from_jax(
    emb: np.ndarray,
    valid: np.ndarray,
    types: Optional[np.ndarray],
    n_shards: int,
    rows_per_shard: int,
    device: str | torch.device | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(emb, valid, types) of the port, in slot order on ``device``."""
    dev = resolve_device(device)
    cap = n_shards * rows_per_shard
    if emb.shape[0] != cap or valid.shape[0] != cap:
        raise ValueError(f"expected {cap} physical rows, got {emb.shape[0]}")
    order = np.empty(cap, dtype=np.int64)
    order[physical_to_slot(np.arange(cap), n_shards, rows_per_shard)] = np.arange(cap)
    emb_t = torch.from_numpy(np.asarray(emb, dtype=np.float32)[order]).to(dev, store_dtype(dev))
    valid_t = torch.from_numpy(np.asarray(valid, dtype=bool)[order]).to(dev)
    types_t = None
    if types is not None:
        types_t = torch.from_numpy(np.asarray(types, dtype=np.int32)[order]).to(dev)
    return emb_t, valid_t, types_t


DENSE_LAYER_KEYS = {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down"}
MOE_LAYER_KEYS = {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "we_gate", "we_up", "we_down"}
# The family flags' keys (llama.init_params), each set all or nothing.
FAMILY_LAYER_KEYS = ({"bq", "bk", "bv"}, {"post_attn_norm", "post_ffw_norm"}, {"q_norm", "k_norm"})
MATRIX_KEYS = {"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "we_gate", "we_up", "we_down"}


def _np_to_torch(a) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype; bfloat16 (ml_dtypes, as
    ``np.asarray`` of a JAX bf16 array gives it) goes through f32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def llama_params_from_jax(params_np: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """The port's Llama params from the JAX tree (same keys and layouts, each
    leaf ``np.asarray``-ed). Matrices are cast to ``cfg.dtype`` — what
    ``wmat`` does at every matmul of the JAX forward — and every other leaf
    (norm gains, q/k norms, biases, the MoE router) keeps the dtype the JAX
    tree holds: f32 from ``init_params``, bf16 from the HF loader but for
    Gemma's materialized 1 + w gains, which stay f32. ``rms_norm`` takes
    another branch for f32 gains, so lifting a bf16 gain would round
    differently from the JAX package. Int8 weight-only leaves ``{"q", "s"}``
    cross bit for bit (``q`` int8, ``s`` f32), never re-quantized or cast.
    A layer that is neither dense nor MoE, or carries keys no family flag
    gives, or part of a flag's set, raises."""
    dev = resolve_device(device)

    def leaf(name: str, a):
        if isinstance(a, dict):
            if set(a) != {"q", "s"}:
                raise NotImplementedError(f"{name}: leaf keys {sorted(a)} are not ported")
            return {
                "q": torch.from_numpy(np.array(a["q"], dtype=np.int8)).to(dev),
                "s": torch.from_numpy(np.array(a["s"], dtype=np.float32)).to(dev),
            }
        t = _np_to_torch(a)
        return t.to(dev, cfg.dtype if name in MATRIX_KEYS else t.dtype)

    layers = []
    for layer in params_np["layers"]:
        keys = set(layer)
        for fam in FAMILY_LAYER_KEYS:
            if keys & fam and not fam <= keys:
                raise NotImplementedError(f"layer params {sorted(fam - keys)} missing beside {sorted(keys & fam)}")
            keys -= fam
        if keys not in (DENSE_LAYER_KEYS, MOE_LAYER_KEYS):
            want = MOE_LAYER_KEYS if "router" in keys else DENSE_LAYER_KEYS
            raise NotImplementedError(f"layer params {sorted(keys ^ want)} are not ported yet")
        layers.append({name: leaf(name, a) for name, a in layer.items()})
    return {
        "embed": leaf("embed", params_np["embed"]),
        "layers": layers,
        "final_norm": leaf("final_norm", params_np["final_norm"]),
        "lm_head": leaf("lm_head", params_np["lm_head"]),
    }
