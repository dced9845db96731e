"""Plain PyTorch version of the SSD chunked-scan kernel.

A line-for-line counterpart of the JAX package's
``repro.models.ssm.ssd_chunked`` (the oracle of its Pallas ``ssd_scan``
kernel): the Mamba-2 SSD scan in chunks, quadratic inside a chunk and a
recurrence over chunk states, returning ``(y, final_state)``.

One addition: a sequence that is not a multiple of ``chunk`` is padded at
its end with ``x = B = C = 0`` and ``dta = 0`` (which adds nothing to the
state and decays nothing), and ``y`` is cut back to the sequence. The
oracle asks for a multiple; the kernel handles the ragged chunk itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked"]


def ssd_chunked(x, dta, B, C, chunk: int):
    """Chunked SSD scan.

    x:   (b, s, h, p)   per-head inputs (dt already folded in by caller)
    dta: (b, s, h)      dt * A  (negative)
    B,C: (b, s, n)      input/output projections (single group)
    Returns y (b, s, h, p) and final state (b, h, p, n).
    """
    s0 = x.shape[1]
    pad = -s0 % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dta = F.pad(dta, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = s // chunk
    l = chunk
    xr = x.reshape(b, c, l, h, p)
    ar = dta.reshape(b, c, l, h)
    Br = B.reshape(b, c, l, n)
    Cr = C.reshape(b, c, l, n)

    cs = torch.cumsum(ar, dim=2)                      # (b,c,l,h) inclusive
    last = cs[:, :, -1:, :]                           # (b,c,1,h)

    # ---- intra-chunk (quadratic in l) -----------------------------------
    # decay(t, s) = exp(cs_t - cs_s) for s <= t
    dec = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,c,t,s,h)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    dec = torch.where(mask[None, None, :, :, None], dec, -torch.inf)
    dec = torch.exp(dec)
    g = torch.einsum("bctn,bcsn->bcts", Cr, Br)                # (b,c,t,s)
    m = (g[..., None] * dec).to(x.dtype)                       # (b,c,t,s,h)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xr)

    # ---- chunk boundary states ------------------------------------------
    w = torch.exp(last - cs).to(x.dtype)                       # (b,c,l,h)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", w, Br, xr)  # (b,c,h,p,n)

    # ---- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(last[:, :, 0, :])                  # (b,c,h)
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(c):                                         # emit pre-chunk state
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None].to(carry.dtype) \
            + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (b,c,h,p,n)

    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp",
                           Cr, prev_states, torch.exp(cs).to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s0], carry
