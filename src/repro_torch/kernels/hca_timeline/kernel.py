"""Wrapper of the ``hca_timeline`` kernel (``csrc/hca_timeline.cu``).

:func:`hca_timeline` takes one round of HCA's tree: a ``(K, row)`` float64
tensor of each pair's latencies and the pairs' true times. On CUDA tensors
it launches the kernel on the current stream, or raises; on CPU tensors it
runs the plain version (:func:`.ref.hca_timeline_ref`). A kernel that
fails to build or launch raises; it is never replaced by the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_library
from .ref import hca_timeline_ref, row_edges, row_length

__all__ = ["hca_timeline", "load_kernel"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "hca_timeline.cu"


@functools.lru_cache(maxsize=1)
def load_kernel() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns ``(lib, log)``."""
    lib, log = build_library(_SOURCE, {}, flags=("--fmad=false",))
    fn = lib.hca_timeline_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 8
                   + [ctypes.c_void_p] * 2 + [ctypes.c_double] * 2
                   + [ctypes.c_void_p] * 8)
    return lib, log


def _check(lat, t_ref, t_cli, warmup, counted, nseg, nx):
    if min(warmup, counted, nx) < 1 or nseg < 0:
        raise ValueError(f"hca_timeline: warmup, counted and nx must be at "
                         f"least 1 and nseg at least 0, got {warmup}, "
                         f"{counted}, {nx}, {nseg}")
    if lat.dim() != 2 or lat.shape[1] != row_length(warmup, counted, nseg, nx):
        raise ValueError(f"hca_timeline: lat must be (K, "
                         f"{row_length(warmup, counted, nseg, nx)}), got "
                         f"{tuple(lat.shape)}")
    for name, x in (("lat", lat), ("t_ref", t_ref), ("t_cli", t_cli)):
        if x.dtype != torch.float64:
            raise TypeError(f"hca_timeline: {name} must be float64, got {x.dtype}")
        if x.device != lat.device:
            raise ValueError(f"hca_timeline: {name} is on {x.device}, lat on {lat.device}")
    for name, x in (("t_ref", t_ref), ("t_cli", t_cli)):
        if x.shape != lat.shape[:1]:
            raise ValueError(f"hca_timeline: {name} must be ({lat.shape[0]},), "
                             f"got {tuple(x.shape)}")


def hca_timeline(lat, t_ref, t_cli, *, warmup, counted, nseg, nx, oh):
    """The round's true times: ``(c_send, c_recv, srv, recv, t_ref,
    t_cli)``, as :func:`.ref.hca_timeline_ref` defines them. Counts each
    kernel launch in ``hca_timeline.launches``."""
    warmup, counted, nseg, nx, oh = int(warmup), int(counted), int(nseg), int(nx), float(oh)
    _check(lat, t_ref, t_cli, warmup, counted, nseg, nx)
    if lat.device.type == "cpu":
        return hca_timeline_ref(lat, t_ref, t_cli, warmup=warmup, counted=counted,
                                nseg=nseg, nx=nx, oh=oh)
    if lat.device.type != "cuda":
        raise ValueError(f"hca_timeline: no kernel for device {lat.device}")
    K = lat.shape[0]
    if K >= 2**31:
        raise ValueError(f"hca_timeline: {K} pairs, at most 2**31 - 1")
    lat, t_ref, t_cli = (x.contiguous() for x in (lat, t_ref, t_cli))
    new = functools.partial(torch.empty, dtype=torch.float64, device=lat.device)
    c_send, c_recv = new((K, counted)), new((K, counted))
    srv, recv = new((K, nseg * nx)), new((K, nseg * nx))
    seg = new((K, 3, nseg))
    t_ref_out, t_cli_out = new(K), new(K)
    if K == 0:
        return c_send, c_recv, srv, recv, t_ref_out, t_cli_out
    lib, _ = load_kernel()
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream(lat.device).cuda_stream
        err = lib.hca_timeline_launch(
            lat.data_ptr(), K, lat.shape[1], *row_edges(warmup, counted, nseg, nx)[1:6], nx,
            t_ref.data_ptr(), t_cli.data_ptr(), oh, 3 * oh,
            c_send.data_ptr(), c_recv.data_ptr(), srv.data_ptr(), recv.data_ptr(),
            seg.data_ptr(), t_ref_out.data_ptr(), t_cli_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hca_timeline kernel launch failed: CUDA error {err}")
    hca_timeline.launches += 1
    return c_send, c_recv, srv, recv, t_ref_out, t_cli_out


hca_timeline.launches = 0
