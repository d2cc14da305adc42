"""Flash-decode (``csrc/flash_decode.cu``), paged and contiguous, and
their plain versions.

Replaces ``repro.kernels.flash_decode.flash_decode_paged`` and
``flash_decode`` on the card.  The reference wrote these kernels for its
decode step but reads the cache with a gather and an einsum instead
(``attention._update_read_paged`` / ``_update_read_contiguous``); the
port launches the kernels there for bf16 caches.  The plain versions
compute what that decode step computes: q.k in f32, f32 softmax, the
normalised probabilities rounded to the values' dtype for P.V (a no-op
for f32 inputs, where they are the reference's ``flash_decode_paged_ref``
and ``flash_decode_ref``), f32 accumulation, output in q's dtype.

* **paged** — q ``(B, Hkv, G, hd)``; pools ``(NB, Hkv, bs, hd)``;
  block_tables ``(B, MB)`` int32; positions ``(B,)`` int32, the last
  valid logical index of each row (inclusive).  Every row needs at
  least one valid key.  ``window`` (not in the reference kernel) keeps
  keys at ``idx > positions - window``, as the reference's decode mask
  does for sliding-window configs.
* **contiguous** — k/v ``(B, Hkv, C, hd)``; kv_len ``(1,)`` int32, the
  number of valid slots of every row (a ring buffer's filled slots hold
  keys out of position order, which a softmax does not mind).  On the
  card kv_len stays on the device: the kernel reads it itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0              # flash_decode_paged launches since the last reset
launches_contiguous = 0   # flash_decode launches since the last reset
MAX_HEAD_DIM = 256
MAX_GROUP = 16

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ARGS_CONTIGUOUS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]


def attend_decode(q, keys, vals, valid, scale):
    """Masked one-token attention of the reference's decode step, the
    read of every cache that no kernel serves: q rounded to the keys'
    dtype, f32 logits and softmax, P rounded to the values' dtype, f32
    P.V, f32 out.  valid: (B, C); masked values are selected to 0 (a
    recycled block may hold NaN, and 0 * NaN = NaN)."""
    logits = torch.einsum("bhgd,bhcd->bhgc", q.to(keys.dtype).float(),
                          keys.float()) * scale
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    vals = torch.where(valid[:, None, :, None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("bhgc,bhcd->bhgd", p.to(vals.dtype).float(),
                        vals.float())


def _check_operands(name, q, k, v):
    b, h, g, d = q.shape
    for label, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {label} must be a bf16 CUDA tensor, got "
                             f"{x.dtype} on {x.device}")
    if k.shape != v.shape or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match "
                         f"q{tuple(q.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or g > MAX_GROUP:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 and "
                         f"<= {MAX_HEAD_DIM}; group {g} <= {MAX_GROUP}")


def flash_decode_ref(q, k, v, kv_len, *, scale=None):
    """Attend slots ``idx < kv_len[0]`` of the contiguous cache."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    idx = torch.arange(k.shape[2], device=q.device)
    valid = (idx < kv_len.to(q.device).long().reshape(-1)[0])[None, :]
    return attend_decode(q, k, v, valid.expand(q.shape[0], -1),
                         scale).to(q.dtype)


def flash_decode(q, k, v, kv_len, *, scale=None) -> torch.Tensor:
    """Kernel of :func:`flash_decode_ref` for a bf16 cache; kv_len is a
    (1,) int32 CUDA tensor with 0 <= kv_len <= C.  One cluster launch
    that allocates nothing but ``out``."""
    global launches_contiguous
    _check_operands("flash_decode", q, k, v)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} has another "
                         f"batch than q{tuple(q.shape)}")
    if not kv_len.is_cuda or kv_len.dtype != torch.int32 or kv_len.numel() != 1:
        raise ValueError("flash_decode: kv_len must be a (1,) int32 CUDA tensor")
    b, h, g, d = q.shape
    c = k.shape[2]
    q, k, v = (build.aligned16(x) for x in (q, k, v))
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    build.launch("flash_decode", "flash_decode_bf16", _ARGS_CONTIGUOUS, q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), b, h, g, d, c, float(scale))
    launches_contiguous += 1
    return out


def flash_decode_paged_ref(q, k_pool, v_pool, block_tables, positions, *,
                           scale=None, window=None):
    """Gather the table, mask ``idx <= positions[b]``, softmax."""
    b, h, g, d = q.shape
    bs = k_pool.shape[2]
    mb = block_tables.shape[1]
    scale = d ** -0.5 if scale is None else scale
    tbl = block_tables.long()

    def gather(pool):                      # (B, MB, Hkv, bs, d) -> (B, Hkv, C, d)
        return pool[tbl].transpose(1, 2).reshape(b, h, mb * bs, d)

    idx = torch.arange(mb * bs, device=q.device)[None, :]
    pos = positions.to(q.device).long()[:, None]
    valid = idx <= pos
    if window is not None:
        valid &= idx > pos - window
    return attend_decode(q, gather(k_pool), gather(v_pool), valid,
                         scale).to(q.dtype)


def flash_decode_paged(q, k_pool, v_pool, block_tables, positions, *,
                       scale=None, window=None) -> torch.Tensor:
    """Kernel of :func:`flash_decode_paged_ref` for bf16 pools; the
    tables and positions stay on the card.  One cluster launch that
    allocates nothing but ``out``."""
    global launches
    _check_operands("flash_decode_paged", q, k_pool, v_pool)
    b, h, g, d = q.shape
    for label, x in (("block_tables", block_tables), ("positions", positions)):
        if not x.is_cuda or x.dtype != torch.int32 or x.shape[0] != b:
            raise ValueError(f"flash_decode_paged: {label} must be int32 on "
                             f"the card with {b} rows")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode_paged: window must be >= 1, got {window}")
    bs = k_pool.shape[2]
    mb = block_tables.shape[1]
    q, k_pool, v_pool = (build.aligned16(x) for x in (q, k_pool, v_pool))
    tables = block_tables.contiguous()
    positions = positions.contiguous()
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    build.launch("flash_decode", "flash_decode_paged_bf16", _ARGS, q.device,
                 q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), positions.data_ptr(), out.data_ptr(), b, h,
                 g, d, bs, mb, float(scale),
                 -1 if window is None else int(window))
    launches += 1
    return out
