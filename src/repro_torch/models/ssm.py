"""State-space and recurrent blocks: Mamba (jamba) and xLSTM's mLSTM and
sLSTM (``repro.models.ssm``).

The full-sequence forms are the reference's: Mamba's linear recurrence
chunk by chunk, an associative scan within a chunk and the chunks chained
through their boundary state; mLSTM's parallel decay-matrix form; sLSTM
as a loop over time.  Decode takes one token through the recurrent
update.  The recurrences run in f32 and the conv window in bf16, with
bf16 block outputs, op by op as the reference rounds them; the
projections go through ``apply_linear`` (so a quantized weight takes its
kernel on the card).

A decode state is a NamedTuple of tensors that the decode functions
update **in place** and return, as the KV caches are: a batch-1 slot
view (``state._replace(c=state.c[slot:slot + 1], ...)``) writes through
to the slot's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import apply_linear, init_linear
from repro_torch.models.layers import log_sigmoid, sigmoid, silu, softplus


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _store(state: NamedTuple, new: NamedTuple) -> NamedTuple:
    """Copy ``new``'s fields into ``state``'s tensors, in place."""
    for dst, src in zip(state, new):
        dst.copy_(src)
    return state


# ================================================================ Mamba

class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_inner, conv_k - 1) bf16 rolling conv window
    ssm: torch.Tensor   # (B, d_inner, d_state) f32


def mamba_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.ssm_expand * cfg.d_model, cfg.ssm_state


def _dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d_in, d_state = mamba_dims(cfg)
    rank = _dt_rank(cfg)
    dev = gen.device
    in_proj = init_linear(gen, cfg.d_model, 2 * d_in, role="ssm_in")
    conv_w = _normal(gen, (d_in, cfg.ssm_conv), 0.2).to(torch.bfloat16)
    x_proj = init_linear(gen, d_in, rank + 2 * d_state, role="ssm_x")
    dt_proj = init_linear(gen, rank, d_in, role="ssm_x", bias=True)
    out_proj = init_linear(gen, d_in, cfg.d_model, role="ssm_out")
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj, "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), dtype=torch.bfloat16, device=dev),
        "x_proj": x_proj, "dt_proj": dt_proj,
        "A_log": torch.log(a.expand(d_in, d_state).contiguous()),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _mamba_core(p: dict, cfg: ModelConfig, xz: torch.Tensor,
                conv_state: torch.Tensor | None):
    """xz (B, S, 2*d_in) -> (x after the depthwise causal conv and SiLU,
    z, the new conv window (B, d_in, k-1) in xz's dtype).  The conv sums
    its k taps in f32 in tap order."""
    x, z = xz.chunk(2, dim=-1)
    kconv, s = cfg.ssm_conv, x.shape[1]
    if conv_state is None:
        xp = F.pad(x, (0, 0, kconv - 1, 0))
    else:
        xp = torch.cat([conv_state.transpose(1, 2), x], dim=1)
    w = p["conv_w"].float()
    xc = xp[:, 0:s].float() * w[:, 0]
    for j in range(1, kconv):
        xc = xc + xp[:, j:j + s].float() * w[:, j]
    xc = silu(xc + p["conv_b"].float()).to(x.dtype)
    return xc, z, xp[:, -(kconv - 1):].transpose(1, 2)


def _selective_params(p: dict, cfg: ModelConfig, xc: torch.Tensor):
    """-> (exp(dt * A), dt * B * x, C), (B, S, d_in, N) f32 and (B, S, N)."""
    _, d_state = mamba_dims(cfg)
    rank = _dt_rank(cfg)
    dbc = apply_linear(p["x_proj"], xc)                    # (B,S,rank+2N)
    dt, bmat, cmat = dbc.split([rank, d_state, d_state], dim=-1)
    dt = softplus(apply_linear(p["dt_proj"], dt).float())
    a = -torch.exp(p["A_log"])                             # (d_in, N)
    da = torch.exp(dt[..., None] * a)
    dbx = dt[..., None] * bmat[:, :, None, :].float() * xc[..., None].float()
    return da, dbx, cmat.float()


MAMBA_CHUNK = 256


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


def associative_scan(fn, elems: tuple, dim: int = 1) -> tuple:
    """``jax.lax.associative_scan(fn, elems, axis=dim)`` with JAX's own
    odd/even recursion, so that ``fn`` combines the same pairs in the same
    order: adjacent pairs are combined, the half-length result scanned
    recursively (the odd outputs), and each even output combines the odd
    output before it with its own element."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(fn, fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                                  tuple(sl(e, 1, None, 2) for e in elems)), dim)
    if n % 2 == 0:
        even = fn(tuple(sl(o, 0, -1) for o in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full_view = full.movedim(dim, 0)
        full_view[0] = e.movedim(dim, 0)[0]
        full_view[2::2] = ev.movedim(dim, 0)
        full_view[1::2] = od.movedim(dim, 0)
        out.append(full)
    return tuple(out)


def mamba_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Chunked-parallel form over x (B, S, d): within a chunk the linear
    recurrence ``h_t = da_t * h_{t-1} + dbx_t`` is an associative scan,
    and the chunks are chained through their last state.  S must be a
    multiple of the chunk (``cfg.mamba_chunk``, else MAMBA_CHUNK, at most
    S), as in the reference."""
    b, s, _ = x.shape
    d_in, d_state = mamba_dims(cfg)
    xz = apply_linear(p["in_proj"], x)
    xc, z, _ = _mamba_core(p, cfg, xz, None)
    da, dbx, cmat = _selective_params(p, cfg, xc)
    chunk = min(cfg.mamba_chunk or MAMBA_CHUNK, s)
    assert s % chunk == 0, (s, chunk)
    h0 = torch.zeros((b, d_in, d_state), dtype=torch.float32, device=x.device)
    hs = []
    for c0 in range(0, s, chunk):
        cum_a, inner = associative_scan(
            _combine, (da[:, c0:c0 + chunk], dbx[:, c0:c0 + chunk]))
        h = inner + cum_a * h0[:, None]
        h0 = h[:, -1]
        hs.append(h)
    h = torch.cat(hs, dim=1)                               # (B,S,d_in,N)
    y = (h * cmat[:, :, None, :]).sum(-1)
    y = y + p["D"] * xc.float()
    y = (y * silu(z.float())).to(x.dtype)
    return apply_linear(p["out_proj"], y)


def init_mamba_state(batch: int, cfg: ModelConfig, device=None) -> MambaState:
    d_in, d_state = mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, d_in, cfg.ssm_conv - 1), dtype=torch.bfloat16,
                         device=device),
        ssm=torch.zeros((batch, d_in, d_state), dtype=torch.float32,
                        device=device))


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One token x (B, 1, d) -> (y (B, 1, d), state updated in place)."""
    xz = apply_linear(p["in_proj"], x)
    xc, z, new_conv = _mamba_core(p, cfg, xz, state.conv)
    da, dbx, cmat = _selective_params(p, cfg, xc)          # S = 1
    h = da[:, 0] * state.ssm + dbx[:, 0]                   # (B,d_in,N)
    y = (h * cmat[:, 0, None, :]).sum(-1)[:, None, :]
    y = y + p["D"] * xc.float()
    y = (y * silu(z.float())).to(x.dtype)
    _store(state, MambaState(new_conv, h))
    return apply_linear(p["out_proj"], y), state


# ================================================================ xLSTM

class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, hd, hd) matrix memory
    n: torch.Tensor  # (B, H, hd) normalizer
    m: torch.Tensor  # (B, H) log-stabilizer


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """mLSTM block: q, k, v, exponential input and forget gates (one per
    head), the output projection and the output gate."""
    h, hd, d = cfg.num_heads, cfg.hd, cfg.d_model
    return {
        "wq": init_linear(gen, d, h * hd, role="attn_qkv"),
        "wk": init_linear(gen, d, h * hd, role="attn_qkv"),
        "wv": init_linear(gen, d, h * hd, role="attn_qkv"),
        "wi": init_linear(gen, d, h, role="ssm_x", bias=True),
        "wf": init_linear(gen, d, h, role="ssm_x", bias=True),
        "wo": init_linear(gen, h * hd, d, role="attn_out"),
        "ogate": init_linear(gen, d, h * hd, role="ssm_in"),
    }


def _mlstm_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """-> q, k (scaled by hd^-0.5), v (B, H, S, hd) f32; i, f (B, H, S) f32."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    scale = hd ** -0.5

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2).float()
    q = heads(apply_linear(p["wq"], x)) * scale
    k = heads(apply_linear(p["wk"], x)) * scale
    v = heads(apply_linear(p["wv"], x))
    i = apply_linear(p["wi"], x).float().transpose(1, 2)
    f = apply_linear(p["wf"], x).float().transpose(1, 2)
    return q, k, v, i, f


_CUMSUM_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis in the order XLA's CPU backend sums
    the reference's ``jnp.cumsum`` (a window sum that its rewriter splits
    into blocks of 16): one term at a time within each block of 16, and
    each block's total prefix (the same sum over the block totals, one
    level up) added to its terms.  torch's own CPU cumsum accumulates in
    f64 and rounds otherwise."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        out = torch.empty_like(x)
        acc = out[..., 0] = x[..., 0]
        for t in range(1, n):
            acc = out[..., t] = acc + x[..., t]
        return out
    nb = -(-n // _CUMSUM_BLOCK)
    blocks = F.pad(x, (0, nb * _CUMSUM_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _CUMSUM_BLOCK)
    within = _cumsum(blocks)
    before = _cumsum(within[..., -1])                      # (..., nb)
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], -1)
    out = within + before[..., None]
    return out.reshape(*x.shape[:-1], nb * _CUMSUM_BLOCK)[..., :n]


def mlstm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Parallel form (the xLSTM paper's decay matrix with its
    stabiliser) over x (B, S, d)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    q, k, v, i, f = _mlstm_qkv(p, cfg, x)
    cum = _cumsum(log_sigmoid(f))                          # (B,H,S)
    # D[t, s'] = exp(cum[t] - cum[s'] + i[s']) for s' <= t (log domain).
    dmat = cum[:, :, :, None] - cum[:, :, None, :] + i[:, :, None, :]
    tmask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~tmask, float("-inf"))
    m = dmat.amax(dim=-1, keepdim=True)                    # stabiliser
    dexp = torch.exp(dmat - m)
    scores = torch.matmul(q, k.transpose(-1, -2)) * dexp
    norm = torch.maximum(scores.sum(-1, keepdim=True).abs(), torch.exp(-m))
    out = torch.matmul(scores / norm, v)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    o = sigmoid(apply_linear(p["ogate"], x).float())
    return apply_linear(p["wo"], (out * o).to(x.dtype))


def init_mlstm_state(batch: int, cfg: ModelConfig, device=None) -> MLSTMState:
    h, hd = cfg.num_heads, cfg.hd
    return MLSTMState(
        c=torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        m=torch.full((batch, h), -1e30, dtype=torch.float32, device=device))


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """One token x (B, 1, d) -> (y (B, 1, d), state updated in place).
    The matrix memory is scaled and added to in place: ``fg * c`` and the
    outer product ``(ig * v) k^T`` are rounded as the reference rounds
    them, then summed."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.hd
    q, k, v, i, f = _mlstm_qkv(p, cfg, x)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]           # (B,H,hd)
    i, f = i[:, :, 0], f[:, :, 0]                          # (B,H)
    logf = log_sigmoid(f)
    m_new = torch.maximum(logf + state.m, i)
    fg = torch.exp(logf + state.m - m_new)[..., None]
    ig = torch.exp(i - m_new)[..., None]
    c = state.c.mul_(fg[..., None]).add_((ig * v)[..., None] * k[:, :, None, :])
    n = state.n.mul_(fg).add_(ig * k)
    state.m.copy_(m_new)
    hnum = torch.matmul(c, q[..., None])[..., 0]           # (B,H,hd)
    hden = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))[..., None]
    out = (hnum / hden).reshape(b, 1, h * hd)
    o = sigmoid(apply_linear(p["ogate"], x).float())
    return apply_linear(p["wo"], (out * o).to(x.dtype)), state


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p = {w: init_linear(gen, d, d, role=role, bias=True)
         for w, role in (("wz", "ssm_in"), ("wi", "ssm_x"), ("wf", "ssm_x"),
                         ("wo_gate", "ssm_x"))}
    p["r"] = _normal(gen, (4, d), 0.1)
    p["out"] = init_linear(gen, d, d, role="ssm_out")
    return p


def init_slstm_state(batch: int, cfg: ModelConfig, device=None) -> SLSTMState:
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return SLSTMState(z(), z(), z(), torch.full_like(z(), -1e30))


def _slstm_step(p: dict, state: SLSTMState, gates) -> SLSTMState:
    zt, it, ft, ot = gates                                 # (B,D) each f32
    rz, ri, rf, ro = p["r"]
    zt = torch.tanh(zt + rz * state.h)
    it = it + ri * state.h
    ft = ft + rf * state.h
    ot = sigmoid(ot + ro * state.h)
    logf = log_sigmoid(ft)
    m_new = torch.maximum(logf + state.m, it)
    fg = torch.exp(logf + state.m - m_new)
    ig = torch.exp(it - m_new)
    c = fg * state.c + ig * zt
    n = fg * state.n + ig
    h = ot * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h, m_new)


_GATES = ("wz", "wi", "wf", "wo_gate")


def slstm_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Recurrent loop over time (sLSTM does not parallelise over S)."""
    b, s, _ = x.shape
    gates = [apply_linear(p[w], x).float() for w in _GATES]   # (B,S,D) x4
    state = init_slstm_state(b, cfg, x.device)
    hs = []
    for t in range(s):
        state = _slstm_step(p, state, [g[:, t] for g in gates])
        hs.append(state.h)
    return apply_linear(p["out"], torch.stack(hs, dim=1).to(x.dtype))


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """One token x (B, 1, d) -> (y (B, 1, d), state updated in place)."""
    gates = [apply_linear(p[w], x)[:, 0].float() for w in _GATES]
    new = _slstm_step(p, state, gates)
    _store(state, new)
    return apply_linear(p["out"], new.h[:, None].to(x.dtype)), state
