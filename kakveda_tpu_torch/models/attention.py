"""Cached GQA attention for the Llama runtime, and the flash kernel's wrapper.

Counterpart of ``kakveda_tpu/models/attention.py``, same contract:

``gqa_cache_attention(q, k, v, pos0, kv_valid)``
    q          [B, S, H, D]   queries (prefill chunk or decode step)
    k, v       [B, KV, L, D]  head-major KV cache (cfg.dtype, or int8 with
                              ``k_scale``/``v_scale`` [B, KV, L] f32)
    pos0       int, or [B]    cache slot of q[:, 0]: one for the batch, or
                              a device int32 tensor, one per batch row
                              (the engine's verify chunk: slot b's query i
                              sits at slot_pos[b] + i)
    kv_valid   [B, L] bool    optional per-slot validity (left-pad batching)
    -> [B, S, H, D]

* :func:`flash_gqa_cache` replaces the Pallas TPU kernel of the same name
  (``pl.pallas_call`` at ``kakveda_tpu/models/attention.py:284``, bodies
  ``_flash_kernel`` and ``_flash_kernel_kv8``). On a CUDA tensor it launches
  a hand-written kernel or raises: ``kakveda_tpu_torch/csrc/
  flash_gqa_cache.cu`` for a bf16 ``q`` (bf16 or int8 cache) and
  ``csrc/flash_gqa_cache_f32.cu`` for an f32 one (built by ``nvcc`` for
  ``sm_90a`` at first use, one library per head_dim); on a CPU tensor
  it runs :func:`flash_gqa_cache_reference`, the plain version with the
  kernel's own semantics, which is also the kernel's oracle on the card.
  The kernel splits the cache across blocks (:func:`flash_split_count`,
  :func:`flash_split_plan`) and skips tiles that no query row of a block
  can see (:func:`flash_live_tiles`);
  :func:`flash_gqa_cache_split_reference` is the plain version of that
  split schedule, with the same combine.
* :func:`gqa_grouped` is the twin of ``_gqa_xla``, which the JAX package
  runs wherever its Pallas kernel does not (``_flash_ok``, the
  ``full_mask`` and softcap branches of its dispatch). On the CPU it serves
  softcap (Gemma-2) attention and an arbitrary per-query ``full_mask``, as
  ``_gqa_xla`` does. On the card :func:`card_path` decides, from the dtype,
  the head_dim, the cache type and whether a ``full_mask`` is given, which
  of the kernel's bodies runs or whether ``gqa_grouped`` does: a head_dim
  or a dtype that no body takes (f16, f32 at D = 80, an f32 model over an
  int8 cache) and a ``full_mask`` take it; a softcap goes through the flash
  kernel, which caps the scores in the same order. The speculative verify
  chunk's mask, which the JAX package passes as a ``full_mask``, is the
  causal mask at per-row positions: a ``[B]`` ``pos0`` here, on both
  devices.

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
KERNEL_MAX_TILES_PER_SPLIT = 256  # the kernel's live-tile list holds this many
KERNEL_MAX_SPLITS = 64  # the kernel's combine keeps this many splits' weights
KERNEL_HEAD_DIMS = _build.FLASH_HEAD_DIMS  # the bf16 and int8-cache bodies
KERNEL_F32_HEAD_DIMS = _build.FLASH_F32_HEAD_DIMS  # the f32 body


def _positions(pos0, n: int, r: int, dev) -> torch.Tensor:
    """Sequence position of each of ``n`` folded rows, ``pos0 + i // r``:
    [n] for a host int, [B, n] for a per-row ``[B]`` tensor."""
    i = torch.arange(n, device=dev) // r
    if torch.is_tensor(pos0):
        return pos0.to(device=dev, dtype=torch.long)[:, None] + i[None, :]
    return pos0 + i


def _causal_keep(q_pos: torch.Tensor, l0: int, l1: int, window: int) -> torch.Tensor:
    """``[B or 1, 1, rows, l1 - l0]`` bool: cache row l is visible to a query
    at ``q_pos`` (``[rows]`` or ``[B, rows]``) when l ≤ q_pos and, with a
    window, q_pos − l < window."""
    l_pos = torch.arange(l0, l1, device=q_pos.device)
    keep = q_pos[..., :, None] >= l_pos
    if window:
        keep &= (q_pos[..., :, None] - l_pos) < window
    return keep[:, None] if keep.dim() == 3 else keep[None, None]


def gqa_grouped(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0,
    kv_valid: Optional[torch.Tensor],
    window: int = 0,
    softcap: float = 0.0,
    full_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped attention with the GQA group axis explicit (K/V are never
    repeated to H heads) — the twin of ``_gqa_xla``. ``full_mask`` [B, S, L]
    replaces the causal/window/kv_valid mask; ``pos0`` is a host int or a
    ``[B]`` tensor (:func:`_positions`). ``gqa_grouped.launches`` counts its
    calls on the card."""
    if q.device.type == "cuda":
        gqa_grouped.launches += 1
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
        keep = _causal_keep(_positions(pos0, s, 1, q.device), 0, l, window)[:, :, :, None, :]
        if kv_valid is not None:
            keep = keep & kv_valid[:, None, None, None, :]
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgsrl,bgld->bgsrd", probs, v)
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h, d).to(q.dtype)


gqa_grouped.launches = 0


def flash_gqa_cache_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0,
    kv_valid: Optional[torch.Tensor],
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel, step for step: the R group
    heads fold into the q rows (row i is position ``pos0 + i // R``, with
    ``pos0[b]`` for batch row b when ``pos0`` is a ``[B]`` tensor), the
    cache streams in the kernel's 64-row tiles through an f32 online softmax,
    scores are scaled by D^-0.5 and, with ``softcap``, capped at
    ``softcap · tanh(s / softcap)`` before the mask, masked scores are −1e30
    and p is masked again after the exp, P is cast to the cache's compute
    dtype before P·V, and the output is ``acc / max(l, 1e-20)`` — zeros for
    a row that sees no slot.

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
    q_pos = _positions(pos0, sr, r, dev)  # [SR] or [B, SR]
    m = torch.full((b, kv, sr, 1), NEG_INF, device=dev)
    lsum = torch.zeros((b, kv, sr, 1), device=dev)
    acc = torch.zeros((b, kv, sr, d), device=dev)
    scale = d**-0.5
    for l0 in range(0, l, KERNEL_L_BLK):
        l1 = min(l, l0 + KERNEL_L_BLK)
        sc = qf @ kt[:, :, l0:l1].float().transpose(-1, -2) * scale  # [B, KV, SR, lb]
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        keep = _causal_keep(q_pos, l0, l1, window)
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


def kernel_q_rows(sr: int) -> int:
    """Folded q rows of one kernel block: one 16-row tile when S·R ≤ 16
    (every decode step), where the 4 warps split each cache tile, else 64
    (16 a warp)."""
    return 16 if sr <= 16 else 64


def flash_split_count(
    bkv: int, sr: int, l: int, sm_count: int, reach: Optional[int] = None, blocks_per_sm: int = 2
) -> int:
    """How many blocks split one (b·kv, q block)'s cache: as many as keep
    the grid within ``blocks_per_sm`` resident blocks per SM (one wave; the
    kernel's :func:`kernel_blocks_per_sm` at its shape), at least two
    64-row tiles a split, at most ``KERNEL_MAX_SPLITS`` splits (unless a
    cache longer than that many times ``KERNEL_MAX_TILES_PER_SPLIT`` tiles
    needs more, which the wrapper refuses), no empty split and no one-tile
    last split where the caps allow. ``reach`` is one past the last cache
    row any query can see (``pos0 + S``): tiles past it are dead for every
    block, so only the tiles before it ask for splits (an admission at
    ``pos0 = 0`` takes one). A pure function of Python ints: the wrapper
    calls it in the decode loop without touching the device."""
    n_tiles = -(-l // KERNEL_L_BLK)
    reached = n_tiles if reach is None else max(1, min(n_tiles, -(-reach // KERNEL_L_BLK)))
    blocks = bkv * -(-sr // kernel_q_rows(sr))
    n = max(1, min(blocks_per_sm * sm_count // blocks, reached // 2, KERNEL_MAX_SPLITS))
    n = max(n, -(-n_tiles // KERNEL_MAX_TILES_PER_SPLIT))
    tps = -(-n_tiles // n)
    n = -(-n_tiles // tps)
    while n > 1 and n_tiles - (n - 1) * tps < 2:
        wider = -(-n_tiles // (n - 1))
        if wider > KERNEL_MAX_TILES_PER_SPLIT:
            break
        tps = wider
        n = -(-n_tiles // tps)
    return n


def flash_split_plan(l: int, n_split: int, tile: int = KERNEL_L_BLK) -> list:
    """The cache row ranges ``[(l0, l1), ...]`` of the splits, in order: each
    split takes ``ceil(tiles / n_split)`` whole tiles, the last one what is
    left, and a count that would leave a split empty is cut to the splits
    that have rows (the count the kernel is given)."""
    n_tiles = -(-l // tile)
    tps = -(-n_tiles // max(1, n_split))
    return [(z * tps * tile, min(l, (z + 1) * tps * tile)) for z in range(-(-n_tiles // tps))]


def flash_live_tiles(
    l: int,
    pos0,
    r: int,
    row0: int,
    row1: int,
    kv_valid: Optional[torch.Tensor],
    window: int = 0,
    tile: int = KERNEL_L_BLK,
) -> torch.Tensor:
    """``[B, tiles]`` bool (``[1, tiles]`` without ``kv_valid``): which cache
    tiles at least one folded q row of ``[row0, row1)`` can see. The kernel
    makes this test for its block's rows before it loads a tile: a valid
    slot at or before the last row's position and, with a window, inside
    the first row's window. A tile it fails holds no slot any row keeps, so
    dropping it leaves (m, l, acc) exactly as they were. A ``[B]`` ``pos0``
    makes the bounds per batch row, as the kernel reads ``pos0_vec``."""
    dev = kv_valid.device if kv_valid is not None else torch.device("cpu")
    if torch.is_tensor(pos0):
        dev = pos0.device
        pos0 = pos0.long()[:, None]
    qmin = pos0 + row0 // r
    qmax = pos0 + (row1 - 1) // r
    col = torch.arange(l, device=dev)
    ok = col <= qmax
    if window:
        ok &= (qmin - col) < window
    ok = ok if ok.dim() == 2 else ok[None]
    ok = ok if kv_valid is None else ok & kv_valid
    n_tiles = -(-l // tile)
    ok = torch.nn.functional.pad(ok, (0, n_tiles * tile - l))
    return ok.reshape(ok.shape[0], n_tiles, tile).any(dim=-1)


def _online_softmax(qf, kt, vt, q_pos, kv_valid, window, l0, l1, tile, live=None, softcap=0.0):
    """(m, l, acc) of an f32 online softmax over cache rows ``[l0, l1)`` in
    ``tile``-row steps, from the "sees nothing" state (−1e30, 0, 0). With
    ``live`` [B, tiles] a tile that is not live leaves a batch row's state
    as it was (the kernel never loads it)."""
    b, kv, sr, d = qf.shape
    dev = qf.device
    m = torch.full((b, kv, sr, 1), NEG_INF, device=dev)
    lsum = torch.zeros((b, kv, sr, 1), device=dev)
    acc = torch.zeros((b, kv, sr, d), device=dev)
    scale = d**-0.5
    for t0 in range(l0, l1, tile):
        t1 = min(l1, t0 + tile)
        sc = qf @ kt[:, :, t0:t1].float().transpose(-1, -2) * scale
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        keep = _causal_keep(q_pos, t0, t1, window)
        if kv_valid is not None:
            keep = keep & kv_valid[:, None, None, t0:t1]
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(keep, torch.exp(sc - m_new), torch.zeros_like(sc))
        corr = torch.exp(m - m_new)
        l_new = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + p.to(vt.dtype).float() @ vt[:, :, t0:t1].float()
        if live is not None:
            on = live[:, t0 // tile].reshape(-1, 1, 1, 1)
            m_new = torch.where(on, m_new, m)
            l_new = torch.where(on, l_new, lsum)
            acc_new = torch.where(on, acc_new, acc)
        m, lsum, acc = m_new, l_new, acc_new
    return m, lsum, acc


def flash_gqa_cache_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0,
    kv_valid: Optional[torch.Tensor],
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    n_split: int = 1,
    tile: int = KERNEL_L_BLK,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's split schedule: an f32 online
    softmax per split over the row ranges of :func:`flash_split_plan`, then
    the combine ``m* = max mᵢ``, ``l* = Σ lᵢ·e^(mᵢ−m*)``,
    ``out = Σ accᵢ·e^(mᵢ−m*) / max(l*, 1e-20)`` in split order. A split that
    sees nothing is (−1e30, 0, 0) and weighs nothing; a row that no split
    sees is zeros. Everything else as :func:`flash_gqa_cache_reference`,
    which this equals for ``n_split = 1``. Tile skipping is exact and not
    modelled."""
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
    q_pos = _positions(pos0, sr, r, q.device)
    parts = [
        _online_softmax(qf, kt, vt, q_pos, kv_valid, window, l0, l1, tile, softcap=softcap)
        for l0, l1 in flash_split_plan(l, n_split, tile)
    ]
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        w = torch.exp(m - mx)
        lsum = lsum + ls * w
        acc = acc + a * w
    out = (acc / lsum.clamp_min(1e-20)).to(q.dtype)
    return out.reshape(b, kv, s, r, d).permute(0, 2, 1, 3, 4).reshape(b, s, h, d)


_tickets: dict = {}  # device index -> every ticket buffer made there, newest last


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The split combine's atomic tickets on ``device``: zeros that every
    launch leaves zero again, kept across calls so that a captured CUDA
    graph replays on the same buffer. A larger shape gets a new, larger
    buffer, and the old ones are kept alive too: a graph captured before
    the growth still points at its own, which nothing else may reuse. Calls
    on one device share the newest, so they must not run at once on two
    streams (the port launches on one). Grows outside capture only: run a
    shape once before capturing it."""
    bufs = _tickets.setdefault(device.index, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_gqa_cache: the split tickets must grow outside CUDA-graph capture; "
                "call the kernel once at this shape before capturing it"
            )
        size = max(n, 2 * bufs[-1].numel() if bufs else 0)
        bufs.append(torch.zeros(size, dtype=torch.int32, device=device))
    return bufs[-1]


def _lib(d: int, f32: bool = False):
    """The kernel's library for head_dim ``d`` (one per head_dim, built in
    parallel: ``_build.FLASH_HEAD_DIMS``, and ``_build.FLASH_F32_HEAD_DIMS``
    for the f32 body, whose C interface is the same)."""
    lib = _build.load(f"flash_gqa_cache{'_f32' if f32 else ''}:{d}")
    fn = lib.kkv_flash_gqa_cache
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, ll, p, i, i, i, i, i, i, i, i, p, i, f, f, i, p]
        fn.restype = ctypes.c_int
        size = lib.kkv_flash_gqa_cache_part_floats
        size.argtypes = [i, i, i, i]
        size.restype = ll
        blocks = lib.kkv_flash_gqa_cache_blocks_per_sm
        blocks.argtypes = [i, i, i, i]
        blocks.restype = i
    return lib


_blocks = {}


def kernel_blocks_per_sm(d: int, kv8: bool, sr: int, f32: bool = False) -> int:
    """Resident blocks per SM that the kernel's launch bounds plan for at
    head_dim ``d``, body (bf16, int8 cache, or ``f32``) and block rows
    (``Cfg::BLOCKS`` in the CUDA source: two, one where a block's shared
    memory fills the SM, as the D = 256 bf16 ring of 202,752 bytes and the
    D = 128 f32 rings do), read once from the loaded library; the split
    count fills that wave."""
    key = (d, bool(kv8), kernel_q_rows(sr), bool(f32))
    n = _blocks.get(key)
    if n is None:
        n = _blocks[key] = _lib(d, f32).kkv_flash_gqa_cache_blocks_per_sm(d, int(kv8), sr, 1)
    return n


def flash_gqa_cache(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0,
    kv_valid: Optional[torch.Tensor],
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: int = 0,
    reach: Optional[int] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Flash attention of ``q [B, S, H, D]`` over the head-major cache
    ``k, v [B, KV, L, D]``. A CPU tensor takes
    :func:`flash_gqa_cache_reference`; a CUDA tensor launches the kernel or
    raises. The card takes a bf16 ``q`` over a bf16 cache or an int8 cache
    with f32 ``k_scale``/``v_scale`` [B, KV, L] at D ∈ ``KERNEL_HEAD_DIMS``,
    or an f32 ``q`` over an f32 cache at D ∈ ``KERNEL_F32_HEAD_DIMS`` (the
    f32 body: FFMA, f32 end to end), a
    ``softcap`` ≥ 0 (scores capped at ``softcap · tanh(s / softcap)``
    before the mask; 0 is off) and any L up to
    ``KERNEL_MAX_SPLITS × KERNEL_MAX_TILES_PER_SPLIT`` tiles. One launch
    whatever the split count (:func:`flash_split_count`); its workspace is
    a ``torch.empty`` and the per-device tickets of :func:`_ticket_buffer`,
    so calls can be captured in a CUDA graph once a shape has run eagerly.
    ``reach`` is a host-side hint from a caller whose ``kv_valid`` hides
    every row at or past it (the engine's decode step passes one past its
    slots' last row): only the tiles before it ask for splits. It steers
    the schedule alone, never the result — the kernel still masks and
    skips by ``kv_valid`` — so a stale hint (one baked into a captured
    graph) is exact too. ``pos0`` is a host int or a contiguous int32
    ``[B]`` tensor on q's device, read by the kernel (``pos0_vec``), never
    by the host: the schedule then plans from ``reach`` alone (all of L
    without one), so a caller whose positions stay on the card passes a
    host upper bound of ``max(pos0) + S``. ``flash_gqa_cache.launches``
    counts bf16-cache launches, ``flash_gqa_cache.launches_kv8`` int8-cache
    launches, ``flash_gqa_cache.launches_f32`` f32 launches."""
    if q.device.type == "cpu":
        return flash_gqa_cache_reference(
            q, k, v, pos0, kv_valid, k_scale=k_scale, v_scale=v_scale, window=window, softcap=softcap
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_cache: unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape != v.shape or k.shape[3] != d:
        raise ValueError(f"flash_gqa_cache: k/v must be [B, KV, L, {d}], got {tuple(k.shape)}")
    kv, l = k.shape[1], k.shape[2]
    kv8 = k_scale is not None
    f32 = q.dtype == torch.float32
    if q.dtype != torch.bfloat16 and not f32:
        raise ValueError(f"flash_gqa_cache: the card's bodies take a bf16 or f32 q, not {q.dtype}")
    if f32 and kv8:
        raise ValueError("flash_gqa_cache: the f32 body takes an f32 cache, not an int8 one")
    dims = KERNEL_F32_HEAD_DIMS if f32 else KERNEL_HEAD_DIMS
    if d not in dims or h % kv or l < 1 or window < 0 or not softcap >= 0:
        raise ValueError(f"flash_gqa_cache: unsupported layout H={h} KV={kv} L={l} D={d} ({q.dtype})")
    want = torch.int8 if kv8 else q.dtype
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
    if torch.is_tensor(pos0):
        if pos0.shape != (b,) or pos0.dtype != torch.int32 or not pos0.is_contiguous():
            raise ValueError("flash_gqa_cache: a per-row pos0 must be a contiguous int32 [B] tensor")
        tensors.append(pos0)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_gqa_cache: all tensors must be on one device")
    r = h // kv
    sr = s * r
    qf = q.reshape(b, s, kv, r, d).permute(0, 2, 1, 3, 4).reshape(b * kv, sr, d).contiguous()
    out = torch.empty((b * kv, sr, d), dtype=q.dtype, device=q.device)
    if any(t.data_ptr() % 16 for t in (qf, out, k, v)):
        raise ValueError("flash_gqa_cache: tensors must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if torch.is_tensor(pos0):
        hint, pos0_vec, pos0 = (None if reach is None else int(reach)), pos0.data_ptr(), 0
    else:
        hint = int(pos0) + s if reach is None else min(int(pos0) + s, int(reach))
        pos0_vec = None
    lib = _lib(d, f32)
    n_split = flash_split_count(
        b * kv, sr, l, sms, reach=hint, blocks_per_sm=kernel_blocks_per_sm(d, kv8, sr, f32)
    )
    if n_split > KERNEL_MAX_SPLITS:
        raise ValueError(f"flash_gqa_cache: a cache of L={l} rows is longer than the kernel takes")
    part = tickets = None
    if n_split > 1:  # the C side sizes the partials and checks both buffers
        part = torch.empty(
            lib.kkv_flash_gqa_cache_part_floats(b * kv, sr, d, n_split), dtype=torch.float32, device=q.device
        )
        tickets = _ticket_buffer(q.device, b * kv * -(-sr // kernel_q_rows(sr)))
    with torch.cuda.device(q.device):
        rc = lib.kkv_flash_gqa_cache(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
            kv_valid.view(torch.uint8).data_ptr() if kv_valid is not None else None,
            out.data_ptr(), part.data_ptr() if part is not None else None,
            part.numel() if part is not None else 0,
            tickets.data_ptr() if tickets is not None else None,
            tickets.numel() if tickets is not None else 0,
            b * kv, kv, sr, r, l, d, int(pos0), pos0_vec, int(window), d**-0.5, float(softcap), n_split,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_gqa_cache kernel launch failed: cudaError {rc}")
    if kv8:
        flash_gqa_cache.launches_kv8 += 1
    elif f32:
        flash_gqa_cache.launches_f32 += 1
    else:
        flash_gqa_cache.launches += 1
    return out.reshape(b, kv, s, r, d).permute(0, 2, 1, 3, 4).reshape(b, s, h, d)


flash_gqa_cache.launches = 0
flash_gqa_cache.launches_kv8 = 0
flash_gqa_cache.launches_f32 = 0


def card_path(dtype: torch.dtype, d: int, full_mask: bool, kv8: bool) -> str:
    """The card's attention path, a pure function of the query dtype, the
    head_dim, whether a ``full_mask`` is given and whether the cache is
    int8: ``"flash"`` (:func:`flash_gqa_cache`: bf16 over a bf16 or int8
    cache at D ∈ ``KERNEL_HEAD_DIMS``, or f32 over an f32 cache at D ∈
    ``KERNEL_F32_HEAD_DIMS``) or ``"grouped"`` (:func:`gqa_grouped`, where
    the JAX package takes ``_gqa_xla``: a ``full_mask``, another dtype such
    as f16, a head_dim no body takes, and an f32 model over an int8 cache,
    which dequantizes to f32 first as ``_kv_dequant`` does)."""
    if full_mask:
        return "grouped"
    if dtype == torch.bfloat16 and d in KERNEL_HEAD_DIMS:
        return "flash"
    if dtype == torch.float32 and not kv8 and d in KERNEL_F32_HEAD_DIMS:
        return "flash"
    return "grouped"


def _path(q: torch.Tensor, full_mask: bool, kv8: bool, softcap: float) -> str:
    """:func:`card_path` on the card; on the CPU ``"grouped"`` for a
    ``full_mask`` or a softcap (the JAX package's ``_gqa_xla`` branches),
    else ``"flash"`` (the kernel's plain version)."""
    if q.device.type == "cuda":
        return card_path(q.dtype, q.shape[-1], full_mask, kv8)
    return "grouped" if full_mask or softcap else "flash"


def gqa_cache_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos0,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    full_mask: Optional[torch.Tensor] = None,
    reach: Optional[int] = None,
) -> torch.Tensor:
    """Cached GQA attention. On the card :func:`card_path` picks the flash
    kernel's body or :func:`gqa_grouped` (there is no profitability gate:
    ``_flash_wins`` was measured on a TPU, and no path gives way to another
    when a launch fails); a softcap goes to the kernel. On the CPU a softcap
    or a ``full_mask`` takes :func:`gqa_grouped`, as ``_gqa_xla`` serves
    them in the JAX package, and everything else the kernel's plain
    version. An int8 cache dequantizes first (``_kv_dequant``'s order) for
    ``gqa_grouped``. ``window`` > 0 is sliding-window attention; ``pos0`` a
    host int or a ``[B]`` tensor of per-row positions; ``reach`` is
    :func:`flash_gqa_cache`'s schedule hint."""
    if _path(q, full_mask is not None, k_scale is not None, softcap) == "grouped":
        if k_scale is not None:
            k = k.to(q.dtype) * k_scale.to(q.dtype)[..., None]
            v = v.to(q.dtype) * v_scale.to(q.dtype)[..., None]
        return gqa_grouped(q, k, v, pos0, kv_valid, window=window, softcap=softcap, full_mask=full_mask)
    return flash_gqa_cache(
        q, k, v, pos0, kv_valid, k_scale=k_scale, v_scale=v_scale, window=window, reach=reach,
        softcap=softcap,
    )
