"""Wrapper of the Hopper ``sim_scan`` kernel (``csrc/sim_scan.cu``).

:func:`sim_durations_scan` takes ``(R, n)`` float64 rows. On CUDA tensors
it launches the kernel on the current stream, or raises; on CPU tensors it
runs the plain version (:func:`.ref.sim_durations_ref`). There is no other
path: a kernel that fails to build or launch raises, it is never replaced
by the plain version.

The kernel runs one block per tile of ``THREADS * ITEMS`` elements and
carries the AR(1) state across tiles by a decoupled look-back. Each call
gives it a zeroed scratch buffer of 32-byte records: a tile counter, then
one status record per tile (``R * ceil(n / (THREADS * ITEMS))`` of them).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_library
from .ref import ITEMS, THREADS, sim_durations_ref

__all__ = ["sim_durations_scan", "load_kernel"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sim_scan.cu"


@functools.lru_cache(maxsize=1)
def load_kernel() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns ``(lib, log)``."""
    lib, log = build_library(_SOURCE, {"SIM_SCAN_THREADS": THREADS,
                                       "SIM_SCAN_ITEMS": ITEMS},
                             flags=("--fmad=false",))
    fn = lib.sim_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_longlong] * 2
                   + [ctypes.c_double] * 5
                   + [ctypes.c_void_p])
    return lib, log


def _check(eps, u_tail, u_mag, u_spike, state, t0):
    rows = (eps, u_tail, u_mag, u_spike)
    if eps.dim() != 2:
        raise ValueError(f"sim_durations_scan: eps must be (R, n), got "
                         f"shape {tuple(eps.shape)}")
    for name, x in zip(("eps", "u_tail", "u_mag", "u_spike", "state", "t0"),
                       (*rows, state, t0)):
        if x.dtype != torch.float64:
            raise TypeError(f"sim_durations_scan: {name} must be float64, "
                            f"got {x.dtype}")
        if x.device != eps.device:
            raise ValueError(f"sim_durations_scan: {name} is on {x.device}, "
                             f"eps on {eps.device}")
    for name, x in zip(("u_tail", "u_mag", "u_spike"), rows[1:]):
        if x.shape != eps.shape:
            raise ValueError(f"sim_durations_scan: {name} has shape "
                             f"{tuple(x.shape)}, eps {tuple(eps.shape)}")
    for name, x in (("state", state), ("t0", t0)):
        if x.shape != eps.shape[:1]:
            raise ValueError(f"sim_durations_scan: {name} must be "
                             f"({eps.shape[0]},), got {tuple(x.shape)}")


def sim_durations_scan(eps, u_tail, u_mag, u_spike, *, coeff, state, t0,
                       tail_prob, tail_shift, spike_prob, spike_scale):
    """Fused AR(1) scan + tail/spike mixture; returns ``(durations, s)``.

    Same contract as :func:`.ref.sim_durations_ref`. Counts each kernel
    launch in ``sim_durations_scan.launches``.
    """
    _check(eps, u_tail, u_mag, u_spike, state, t0)
    params = dict(coeff=float(coeff), tail_prob=float(tail_prob),
                  tail_shift=float(tail_shift), spike_prob=float(spike_prob),
                  spike_scale=float(spike_scale))
    if eps.device.type == "cpu":
        return sim_durations_ref(eps, u_tail, u_mag, u_spike, state=state,
                                 t0=t0, **params)
    if eps.device.type != "cuda":
        raise ValueError(f"sim_durations_scan: no kernel for device "
                         f"{eps.device}")
    for name, x in (("eps", eps), ("u_tail", u_tail), ("u_mag", u_mag),
                    ("u_spike", u_spike), ("state", state), ("t0", t0)):
        if not x.is_contiguous():
            raise ValueError(f"sim_durations_scan: {name} must be contiguous")
    R, n = eps.shape
    t = torch.empty_like(eps)
    s = torch.empty_like(eps)
    if R == 0 or n == 0:
        return t, s
    tiles = R * -(-n // (THREADS * ITEMS))
    if tiles >= 2**31:
        raise ValueError(f"sim_durations_scan: {tiles} tiles of "
                         f"{THREADS * ITEMS} elements, at most 2**31 - 1")
    lib, _ = load_kernel()
    with torch.cuda.device(eps.device):
        # the tile counter and one status record per tile, 32 bytes each
        scratch = torch.zeros((tiles + 1, 4), dtype=torch.float64,
                              device=eps.device)
        stream = torch.cuda.current_stream(eps.device).cuda_stream
        err = lib.sim_scan_launch(
            eps.data_ptr(), u_tail.data_ptr(), u_mag.data_ptr(),
            u_spike.data_ptr(), state.data_ptr(), t0.data_ptr(),
            t.data_ptr(), s.data_ptr(), scratch.data_ptr(), R, n,
            params["coeff"],
            params["tail_prob"], params["tail_shift"], params["spike_prob"],
            params["spike_scale"], stream)
    if err != 0:
        raise RuntimeError(f"sim_scan kernel launch failed: CUDA error {err}")
    sim_durations_scan.launches += 1
    return t, s


sim_durations_scan.launches = 0
