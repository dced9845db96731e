"""Plain PyTorch version of the fused duration-sampling scan.

The exact math of ``SimCollective.sample_durations`` on pre-drawn noise,
batched over rows (one row per launch epoch of a cost-model term): the
AR(1) recurrence ``s_i = coeff * s_{i-1} + eps_i`` from a per-row
``state``, written as a prefix composition of affine maps ``s -> a*s + b``
(``(a1, b1) . (a2, b2) = (a1*a2, b1*a2 + b2)`` is associative), followed
by the lognormal / bimodal-tail / spike mixture.

The composition is evaluated in the association order of the CUDA kernel
(``csrc/sim_scan.cu``): rows are cut into chunks of ``THREADS * ITEMS``
elements; inside a chunk each thread scans ``ITEMS`` neighbours serially,
lanes combine by a Hillis-Steele scan over the 32 lanes of a warp, warps by
the same scan over the warp totals, and the chunk's prefix maps are applied
to the carry left by the previous chunk. Any order is exact to rounding,
but rounding differences accumulate over ``1 / (1 - |coeff|)`` steps:
at ``coeff = -0.999`` two orders drift ~1e-14 apart, the size of the
comparison bound. In one order the kernel and this function round alike.
"""

from __future__ import annotations

import torch

__all__ = ["sim_durations_ref", "THREADS", "ITEMS"]

#: Threads per block of the CUDA kernel and elements each thread scans
#: serially; passed to ``nvcc`` as ``-D`` flags, so this is the one place
#: that sets the kernel's association order.
THREADS = 256
ITEMS = 4
_WARPS = THREADS // 32


def _shift(x: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """``x`` moved ``d`` places up its last axis, ``fill`` entering below."""
    pad = torch.full_like(x[..., :d], fill)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor, width: int):
    """Hillis-Steele scan of affine maps over the last axis (``width``
    entries), combining with the identity ``(1, 0)`` below each step's
    reach — what the kernel's ``__shfl_up_sync`` steps compute."""
    d = 1
    while d < width:
        pa, pb = _shift(a, d, 1.0), _shift(b, d, 0.0)
        a, b = pa * a, pb * a + b
        d *= 2
    return a, b


def sim_durations_ref(eps, u_tail, u_mag, u_spike, *, coeff, state, t0,
                      tail_prob, tail_shift, spike_prob, spike_scale):
    """Returns ``(durations, s)``, both ``(R, n)`` float64.

    ``eps`` (the AR(1) innovations) and the uniforms ``u_tail``, ``u_mag``,
    ``u_spike`` are ``(R, n)``; ``state`` (the AR(1) carry-in) and ``t0``
    (the term's base time times its epoch bias) are ``(R,)``. A tail fires
    where ``u_tail < tail_prob`` with magnitude ``1 + tail_shift * (0.7 +
    0.6 * u_mag)``, a spike where ``u_spike < spike_prob``.
    """
    R, n = eps.shape
    chunk = THREADS * ITEMS
    nch = max(1, -(-n // chunk))
    e = torch.nn.functional.pad(eps, (0, nch * chunk - n))
    e = e.view(R, nch, _WARPS, 32, ITEMS)

    # per-thread serial scan of ITEMS neighbours
    A = torch.empty_like(e)
    B = torch.empty_like(e)
    A[..., 0] = coeff
    B[..., 0] = e[..., 0]
    for k in range(1, ITEMS):
        A[..., k] = A[..., k - 1] * coeff
        B[..., k] = B[..., k - 1] * coeff + e[..., k]

    # lanes within a warp, then warps within the chunk (exclusive prefixes)
    la, lb = _inclusive_scan(A[..., -1], B[..., -1], 32)
    wa, wb = _inclusive_scan(la[..., -1], lb[..., -1], _WARPS)
    la, lb = _shift(la, 1, 1.0), _shift(lb, 1, 0.0)
    wa, wb = _shift(wa, 1, 1.0), _shift(wb, 1, 0.0)
    pa = wa[..., None] * la
    pb = wb[..., None] * la + lb
    Ea = (pa[..., None] * A).reshape(R, nch, chunk)
    Eb = (pb[..., None] * A + B).reshape(R, nch, chunk)

    # carry across chunks
    s = torch.empty_like(Ea)
    carry = state
    for c in range(nch):
        s[:, c] = Ea[:, c] * carry[:, None] + Eb[:, c]
        carry = s[:, c, -1]
    s = s.reshape(R, nch * chunk)[:, :n]

    t = t0[:, None] * torch.exp(s)
    mag = 1.0 + tail_shift * (0.7 + 0.6 * u_mag)
    t = torch.where(u_tail < tail_prob, t * mag, t)
    t = torch.where(u_spike < spike_prob, t * spike_scale, t)
    return t, s
