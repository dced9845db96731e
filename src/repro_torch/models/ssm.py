"""Mamba-2 state-space blocks via SSD (state-space duality) [arXiv:2405.21060].

The port of the JAX package's ``repro.models.ssm``. Chunked algorithm:
within-chunk attention-like quadratic term + cross-chunk linear state
recurrence (a short loop across chunks). As in the reference,
:func:`ssm_block` runs this module's own :func:`ssd_chunked`, never the
``ssd_scan`` kernel (``repro_torch.kernels.ssd_scan``, whose oracle this
is): routing the model to the kernel is a feature the reference lacks.

Projections for z / x / B / C / dt are separate matrices, and the
depthwise convs are separate per stream, as in the reference.

Decode maintains an O(1) recurrent state, updated in place.
``F.softplus`` is linear above 20 where ``jax.nn.softplus`` is not; the
difference there is below 1e-8 relative.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import _draw, _weight
from .common import ModelConfig, is_dtensor, merge_dims, rms_norm, split_dim

__all__ = [
    "SSM",
    "init_ssm_params",
    "ssm_block",
    "ssm_decode_step",
    "init_ssm_cache",
    "ssd_chunked",
]

CONV_WIDTH = 4


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    nh = cfg.ssm_heads or d_inner // hd
    n = cfg.ssm_state
    return d_inner, hd, nh, n


class SSM(nn.Module):
    """Mamba-2 block weights; :meth:`forward` is :func:`ssm_block`,
    :meth:`decode` :func:`ssm_decode_step`. ``a_log``, ``d_skip`` and
    ``dt_bias`` are f32, as in the reference."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d_inner, hd, nh, n = _dims(cfg)
        d, dt, f32 = cfg.d_model, cfg.torch_dtype, torch.float32
        self.w_z = _weight((d, d_inner), dt, device)
        self.w_x = _weight((d, d_inner), dt, device)
        self.w_b = _weight((d, n), dt, device)
        self.w_c = _weight((d, n), dt, device)
        self.w_dt = _weight((d, nh), dt, device)
        self.conv_x = _weight((CONV_WIDTH, d_inner), dt, device)
        self.conv_b = _weight((CONV_WIDTH, n), dt, device)
        self.conv_c = _weight((CONV_WIDTH, n), dt, device)
        self.a_log = _weight((nh,), f32, device)
        self.d_skip = _weight((nh,), f32, device)
        self.dt_bias = _weight((nh,), f32, device)
        self.norm = _weight((d_inner,), dt, device)
        self.out_proj = _weight((d_inner, d), dt, device)

    def forward(self, x):
        return ssm_block(self.cfg, self, x)

    def decode(self, x, cache: dict):
        return ssm_decode_step(self.cfg, self, x, cache)


@torch.no_grad()
def init_ssm_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cuda") -> SSM:
    p = SSM(cfg, device)
    _draw(p, generator, dict(w_z=0, w_x=0, w_b=0, w_c=0, w_dt=0, out_proj=0),
          zeros=("dt_bias", "norm"))
    for name in ("conv_x", "conv_b", "conv_c"):
        w = getattr(p, name)
        w.copy_(torch.randn(tuple(w.shape), generator=generator,
                            device=generator.device) * 0.1)
    nh = p.a_log.shape[0]
    p.a_log.copy_(torch.log(torch.arange(1, nh + 1, dtype=torch.float32)))
    p.d_skip.fill_(1.0)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (width CONV_WIDTH) via shifted adds + SiLU."""
    out = torch.zeros_like(x)
    s = x.shape[1]
    for i in range(CONV_WIDTH):
        shift = CONV_WIDTH - 1 - i
        shifted = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + shifted * w[i]
    return F.silu(out)


def ssd_chunked(x, dta, B, C, chunk: int):
    """Chunked SSD scan.

    x:   (b, s, h, p)   per-head inputs (dt already folded in by caller)
    dta: (b, s, h)      dt * A  (negative)
    B,C: (b, s, n)      input/output projections (single group)
    Returns y (b, s, h, p) and final state (b, h, p, n).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = s // chunk
    l = chunk
    xr = x.reshape(b, c, l, h, p)
    ar = dta.reshape(b, c, l, h)
    Br = B.reshape(b, c, l, n)
    Cr = C.reshape(b, c, l, n)

    cs = ar.cumsum(dim=2)                             # (b,c,l,h) inclusive
    last = cs[:, :, -1:, :]                           # (b,c,1,h)

    # ---- intra-chunk (quadratic in l) -----------------------------------
    # decay(t, s) = exp(cs_t - cs_s) for s <= t
    dec = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,c,t,s,h)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dec, -math.inf))
    g = torch.einsum("bctn,bcsn->bcts", Cr, Br)                # (b,c,t,s)
    m = (g[..., None] * dec).to(x.dtype)                       # (b,c,t,s,h)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xr)

    # ---- chunk boundary states ------------------------------------------
    w = torch.exp(last - cs).to(x.dtype)                       # (b,c,l,h)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", w, Br, xr)  # (b,c,h,p,n)

    # ---- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(last[:, :, 0, :])                  # (b,c,h)
    carry = x.new_zeros((b, h, p, n))
    prev = []
    for i in range(c):                                         # emit pre-chunk state
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None].to(carry.dtype) + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (b,c,h,p,n)

    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp",
                           Cr, prev_states, torch.exp(cs).to(x.dtype))
    y = merge_dims(y_intra + y_inter, 1)
    return y, carry


def _ssd_on_local_shards(x, dta, B, C, chunk: int):
    """:func:`ssd_chunked` of DTensor inputs on each rank's local shards,
    through ``local_map`` (which spares DTensor's sharding search over the
    5-d einsums). The scan is independent per batch row and per head, and
    B and C are shared by the heads: a mesh dim shards the batch of all
    four, or the heads of x and dta with B and C whole, as x is placed
    where the sizes divide; any other mesh dim is gathered (the sequence
    never splits: the recurrence runs along it). Returns y."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, xp, bp, split = x.device_mesh, [], [], {0: 1, 2: 1}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim in split and \
                x.shape[p.dim] % (split[p.dim] * mesh.size(i)) == 0:
            split[p.dim] *= mesh.size(i)
            xp.append(p)
            bp.append(p if p.dim == 0 else Replicate())
        else:
            xp.append(Replicate())
            bp.append(Replicate())
    x, dta = x.redistribute(mesh, xp), dta.redistribute(mesh, xp)
    B, C = B.redistribute(mesh, bp), C.redistribute(mesh, bp)

    def local(xl, al, bl, cl):
        return ssd_chunked(xl, al, bl, cl, chunk)[0]

    return local_map(local, out_placements=xp, in_placements=(xp, xp, bp, bp),
                     device_mesh=mesh)(x, dta, B, C)


def ssm_block(cfg: ModelConfig, p: SSM, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba-2 block: projections -> conv -> SSD -> gated norm -> out."""
    d_inner, hd, nh, n = _dims(cfg)
    b, s, _ = x.shape
    z = x @ p.w_z
    xin = _causal_conv(x @ p.w_x, p.conv_x)
    B = _causal_conv(x @ p.w_b, p.conv_b)
    C = _causal_conv(x @ p.w_c, p.conv_c)
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias)
    a = -torch.exp(p.a_log)                                            # (nh,)
    dta = dt * a                                                       # (b,s,nh)
    xh = split_dim(xin, -1, (nh, hd))
    xdt = xh * dt[..., None].to(xh.dtype)
    if is_dtensor(xdt):
        y = _ssd_on_local_shards(xdt, dta, B, C, cfg.ssm_chunk)
    else:
        y, _ = ssd_chunked(xdt, dta, B, C, cfg.ssm_chunk)
    y = y + xh * p.d_skip[None, None, :, None].to(xh.dtype)
    y = merge_dims(y, 2)
    y = rms_norm(y * F.silu(z), p.norm)
    return y @ p.out_proj


# ---------------------------------------------------------------------------
# Decode path: O(1) recurrent state
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda") -> dict:
    d_inner, hd, nh, n = _dims(cfg)
    return {
        "state": torch.zeros((batch, nh, hd, n), dtype=dtype, device=device),
        "conv_x": torch.zeros((batch, CONV_WIDTH - 1, d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, CONV_WIDTH - 1, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, CONV_WIDTH - 1, n), dtype=dtype, device=device),
    }


def _conv_step(cache_win, new, w):
    """One step of the causal conv: the window of the last CONV_WIDTH
    inputs times ``w``, then SiLU. Shifts ``new`` into ``cache_win`` in
    place."""
    win = torch.cat([cache_win, new[:, None].to(cache_win.dtype)], dim=1)   # (b, 4, dim)
    out = F.silu(torch.einsum("bwc,wc->bc", win, w))
    cache_win.copy_(win[:, 1:])
    return out


def ssm_decode_step(cfg: ModelConfig, p: SSM, x: torch.Tensor, cache: dict):
    """One-token step. x: (b, 1, d). Returns (out, cache), the cache
    updated in place (the reference returns a new one)."""
    d_inner, hd, nh, n = _dims(cfg)
    b = x.shape[0]
    x0 = x[:, 0]
    z = x0 @ p.w_z
    xin = _conv_step(cache["conv_x"], x0 @ p.w_x, p.conv_x)
    B = _conv_step(cache["conv_b"], x0 @ p.w_b, p.conv_b)
    C = _conv_step(cache["conv_c"], x0 @ p.w_c, p.conv_c)
    dt = F.softplus((x0 @ p.w_dt).float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    decay = torch.exp(dt * a)                                    # (b, nh)
    xh = split_dim(xin, -1, (nh, hd))
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, B, dt.to(xh.dtype))
    state = cache["state"] * decay[:, :, None, None].to(xh.dtype) + upd
    cache["state"].copy_(state)
    y = torch.einsum("bhpn,bn->bhp", state, C)
    y = y + xh * p.d_skip[None, :, None].to(xh.dtype)
    y = merge_dims(y, 1)
    y = rms_norm(y * F.silu(z), p.norm)
    out = (y @ p.out_proj)[:, None]
    return out, cache
