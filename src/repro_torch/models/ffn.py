"""Feed-forward blocks: gated-linear-unit FFNs and Mixture-of-Experts.

The port of the JAX package's ``repro.models.ffn``. The MoE uses a
scatter/gather dispatch with per-expert capacity (GShard style, capacity
factor configurable): expert compute is ``2 * E * C * D * F`` batched
matmuls, ``~cf * k * tokens`` worth of expert work. Dropped tokens fall
back to the residual path, as in Switch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .attention import _draw, _weight
from .common import ModelConfig, activation_fn, is_dtensor

__all__ = ["FFN", "MoE", "init_ffn_params", "ffn_block", "init_moe_params",
           "moe_block"]


class FFN(nn.Module):
    """GLU FFN weights (``w_gate`` when ``cfg.glu``, ``w_up``, ``w_down``);
    :meth:`forward` is :func:`ffn_block`."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, device="cuda",
                 glu: bool | None = None):
        super().__init__()
        self.cfg = cfg
        d_ff = d_ff or cfg.d_ff
        dt = cfg.torch_dtype
        if cfg.glu if glu is None else glu:
            self.w_gate = _weight((cfg.d_model, d_ff), dt, device)
        self.w_up = _weight((cfg.d_model, d_ff), dt, device)
        self.w_down = _weight((d_ff, cfg.d_model), dt, device)

    def forward(self, x):
        return ffn_block(self.cfg, self, x)


def init_ffn_params(cfg: ModelConfig, generator: torch.Generator,
                    d_ff: int | None = None, device="cuda") -> FFN:
    p = FFN(cfg, d_ff, device)
    _draw(p, generator, dict(w_gate=0, w_up=0, w_down=0) if cfg.glu
          else dict(w_up=0, w_down=0))
    return p


def ffn_block(cfg: ModelConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.act)
    if hasattr(p, "w_gate"):
        return (act(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return act(x @ p.w_up) @ p.w_down


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """Routed experts: ``router`` (D, E) in f32, ``w_gate``/``w_up``
    (E, D, F), ``w_down`` (E, F, D), and ``shared`` (a GLU :class:`FFN`
    of ``n_shared_experts * F``) when the config has shared experts;
    :meth:`forward` is :func:`moe_block`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d_ff, e, d, dt = cfg.moe_d_ff or cfg.d_ff, cfg.n_experts, cfg.d_model, cfg.torch_dtype
        self.router = _weight((d, e), torch.float32, device)
        self.w_gate = _weight((e, d, d_ff), dt, device)
        self.w_up = _weight((e, d, d_ff), dt, device)
        self.w_down = _weight((e, d_ff, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = FFN(cfg, cfg.n_shared_experts * d_ff, device, glu=True)

    def forward(self, x):
        return moe_block(self.cfg, self, x)


def init_moe_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cuda") -> MoE:
    p = MoE(cfg, device)
    _draw(p, generator, dict(router=0, w_gate=1, w_up=1, w_down=1))
    if cfg.n_shared_experts:
        _draw(p.shared, generator, dict(w_gate=0, w_up=0, w_down=0))
    return p


def _dispatch(x, flat_e, e: int, capacity: int):
    """Capacity slots for ``flat_e`` (G, N) expert choices of the (G, N, D)
    sources ``x``: each choice's position among its group's choices of the
    same expert (an exclusive cumsum over the flattened order), the valid
    mask (position < capacity), and the (G, E, C, D) buffer with the valid
    sources scattered in. Dropped choices all land at ``capacity - 1`` with
    a zeroed source, as in the reference's ``.at[].add(mode="drop")``."""
    g, n, d = x.shape
    onehot = F.one_hot(flat_e, e)                               # (G, N, E)
    pos_all = onehot.cumsum(dim=1) - onehot                     # exclusive
    pos = pos_all.gather(2, flat_e[..., None])[..., 0]
    valid = pos < capacity
    pos_c = torch.where(valid, pos, capacity - 1)
    src = torch.where(valid[..., None], x, 0)
    gidx = torch.arange(g, device=x.device)[:, None].expand(g, n)
    buf = x.new_zeros((g, e, capacity, d))
    buf.index_put_((gidx, flat_e, pos_c), src, accumulate=True)
    return buf, (gidx, flat_e, pos_c), valid


def _experts(buf, w_gate, w_up, w_down, act):
    """The routed experts' GLU on the (G, E, C, D) dispatch buffer."""
    h = act(torch.einsum("gecd,edf->gecf", buf, w_gate)) * \
        torch.einsum("gecd,edf->gecf", buf, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _experts_on_local_shards(buf, p: MoE, act):
    """:func:`_experts` of a DTensor buffer on each rank's local shards,
    through ``local_map``: DTensor's own backward of the three products
    hands ``aten.view`` a transposed local gradient and fails. Each mesh
    dim splits the work as the weights are placed: experts (EP, the
    weights' ``Shard(0)``) split the buffer's expert dim; the hidden dim
    (TP, ``w_gate``/``w_up`` ``Shard(2)`` and ``w_down`` ``Shard(1)``)
    leaves a partial sum that is reduced at once; any other mesh dim
    splits the groups (dim 0) where the sizes divide, with the weights
    gathered (FSDP), and their gradients are partial sums over it. A mesh
    dim that divides nothing is gathered and each of its ranks computes
    the whole product. Returns the (G, E, C, D) output, placed as the
    buffer is on the EP and group dims and replicated on the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = buf.device_mesh
    g, e, f = buf.shape[0], p.w_gate.shape[0], p.w_gate.shape[2]
    split = {"g": 1, "e": 1, "f": 1}
    bp, wp, dp, op, bgp, wgp, dgp = ([] for _ in range(7))
    R = Replicate()

    def fits(key, size, n):
        if size % (split[key] * n):
            return False
        split[key] *= n
        return True

    for i in range(mesh.ndim):
        n = mesh.size(i)
        pw, pd = p.w_gate.placements[i], p.w_down.placements[i]
        if pw == Shard(0) and pd == Shard(0) and fits("e", e, n):
            row = (Shard(1), Shard(0), Shard(0), Shard(1), Shard(1), Shard(0), Shard(0))
        elif pw == Shard(2) and pd == Shard(1) and fits("f", f, n):
            row = (R, Shard(2), Shard(1), Partial(), Partial(), Shard(2), Shard(1))
        elif fits("g", g, n):
            row = (Shard(0), R, R, Shard(0), Shard(0), Partial(), Partial())
        else:
            row = (R,) * 7
        for lst, pl in zip((bp, wp, dp, op, bgp, wgp, dgp), row):
            lst.append(pl)
    buf = buf.redistribute(mesh, bp)
    wg, wu = (w.redistribute(mesh, wp) for w in (p.w_gate, p.w_up))
    wd = p.w_down.redistribute(mesh, dp)
    out = local_map(lambda b, w1, w2, w3: _experts(b, w1, w2, w3, act),
                    out_placements=op, in_placements=(bp, wp, wp, dp),
                    in_grad_placements=(bgp, wgp, wgp, dgp),
                    device_mesh=mesh)(buf, wg, wu, wd)
    return out.redistribute(mesh, [R if isinstance(pl, Partial) else pl for pl in op])


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts, capacity-based scatter dispatch.

    x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    Two dispatch regimes, as in the reference:

      * **grouped** (training/prefill, S > 64): each sequence is a dispatch
        group, per-group capacity ``cf * k * S / E``;
      * **global** (decode, S <= 64): all B * S tokens form one group.

    Dropped tokens (over capacity) fall back to the residual path (Switch).
    aux_loss is the Switch/GShard load-balancing loss. The reference's two
    ``moe_*`` tuning knobs change only how GSPMD shards this and give the
    same numbers, so there is one path here.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    act = activation_fn(cfg.act)

    gate_logits = x.float() @ p.router                          # (B,S,E)
    probs = torch.softmax(gate_logits, dim=-1)
    # a stable descending sort keeps the lower expert first on ties, as
    # lax.top_k does
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]                   # (B,S,k)
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Load-balancing auxiliary loss (Switch eq. 4).
    density = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    aux = (density * density_proxy).sum() * e

    if s > 64:     # grouped: one dispatch group per sequence
        groups, n = b, s * k
        capacity = max(int(math.ceil(cfg.capacity_factor * k * s / e)), 4)
    else:          # global: every token of the batch in one group
        groups, n = 1, b * s * k
        capacity = max(int(math.ceil(cfg.capacity_factor * k * b * s / e)), 4)
    flat_e = topi.reshape(groups, n)
    src = x.reshape(groups, n // k, d).repeat_interleave(k, dim=1)
    buf, idx, valid = _dispatch(src, flat_e, e, capacity)
    if is_dtensor(buf):
        out_buf = _experts_on_local_shards(buf, p, act)
    else:
        out_buf = _experts(buf, p.w_gate, p.w_up, p.w_down, act)
    gathered = torch.where(valid[..., None], out_buf[idx], 0)   # (G, N, D)
    out = (gathered.reshape(b, s, k, d)
           * topw[..., None].to(gathered.dtype)).sum(dim=2)

    if cfg.n_shared_experts:
        sp = p.shared
        out = out + (act(x @ sp.w_gate) * (x @ sp.w_up)) @ sp.w_down

    return out, aux
