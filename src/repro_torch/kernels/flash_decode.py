"""Paged flash-decode (``csrc/flash_decode.cu``) and its plain version.

Replaces ``repro.kernels.flash_decode.flash_decode_paged`` on the card.
The reference wrote this kernel for the paged serving runtime but its
decode step reads the pool with a gather and an einsum instead
(``attention._update_read_paged``); the port launches the kernel there
for bf16 pools.  The plain version computes what that decode step
computes: q.k in f32, f32 softmax, the normalised probabilities rounded
to the values' dtype for P.V (a no-op for f32 inputs, where it is the
reference's ``flash_decode_paged_ref``), f32 accumulation, output in q's
dtype.

q ``(B, Hkv, G, hd)``; pools ``(NB, Hkv, bs, hd)``; block_tables
``(B, MB)`` int32; positions ``(B,)`` int32, the last valid logical
index of each row (inclusive).  Every row needs at least one valid key.
``window`` (not in the reference kernel) keeps keys at
``idx > positions - window``, as the reference's decode mask does for
sliding-window configs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0          # kernel launches since the last reset
KEYS_PER_SPLIT = 128  # keys per block of the split pass (csrc KEYS)
MAX_HEAD_DIM = 256
MAX_GROUP = 16

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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

    keys, vals = gather(k_pool), gather(v_pool)
    logits = torch.einsum("bhgd,bhcd->bhgc", q.float(), keys.float()) * scale
    idx = torch.arange(mb * bs, device=q.device)[None, :]
    pos = positions.to(q.device).long()[:, None]
    valid = idx <= pos
    if window is not None:
        valid &= idx > pos - window
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    vals = torch.where(valid[:, None, :, None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    out = torch.einsum("bhgc,bhcd->bhgd", p.to(vals.dtype).float(), vals.float())
    return out.to(q.dtype)


def flash_decode_paged(q, k_pool, v_pool, block_tables, positions, *,
                       scale=None, window=None) -> torch.Tensor:
    """Kernel of :func:`flash_decode_paged_ref` for bf16 pools."""
    global launches
    b, h, g, d = q.shape
    for label, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not x.is_cuda or x.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode_paged: {label} must be a bf16 CUDA "
                             f"tensor, got {x.dtype} on {x.device}")
    if k_pool.shape != v_pool.shape or k_pool.shape[1] != h \
            or k_pool.shape[3] != d:
        raise ValueError(f"flash_decode_paged: pools {tuple(k_pool.shape)} do "
                         f"not match q{tuple(q.shape)}")
    if d % 8 or d > MAX_HEAD_DIM or g > MAX_GROUP:
        raise ValueError(f"flash_decode_paged: head dim {d} must be a multiple "
                         f"of 8 and <= {MAX_HEAD_DIM}; group {g} <= {MAX_GROUP}")
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
    nsplit = -(-mb * bs // KEYS_PER_SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    logits = torch.empty((b, h, g, nsplit * KEYS_PER_SPLIT), **f32)
    part_ml = torch.empty((b, h, nsplit, g, 2), **f32)
    part_acc = torch.empty((b, h, nsplit, g, d), **f32)
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    lib, fn = build.entry("flash_decode", "flash_decode_paged_bf16", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  tables.data_ptr(), positions.data_ptr(), logits.data_ptr(),
                  part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, h,
                  g, d, bs, mb,
                  float(scale), -1 if window is None else int(window), stream)
    build.check(lib, "flash_decode_paged", code)
    launches += 1
    return out
