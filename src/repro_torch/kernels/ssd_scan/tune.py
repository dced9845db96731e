"""Choose the SSD chunk walk's p-tile and stage count by measurement.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.tune    # one GPU

Builds ``csrc/ssd_scan.cu`` at each p-tile (one ``nvcc`` each, all
started together), then at mamba2-1.3b's SSD widths (b 1, 64 heads,
p 64, n 128, chunk 64; ``src/repro/configs/mamba2_1_3b.py``) and
S = 1024 and 4096, in f32 and bf16, checks every (p-tile, stages) that
fits the shared memory against the plain version and times it with CUDA
events, in two rounds (forward, then reversed order) on the same inputs.
Prints one line per configuration, then a JSON line of all of them.
"""

from __future__ import annotations

import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from .kernel import _SMEM_LIMIT, _DTYPES, _launch, load_kernel
from .ref import ssd_chunked

P_TILES = (8, 16, 32, 64)
SEQS = (1024, 4096)


def _ms(fn, reps=20) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with ThreadPoolExecutor(len(P_TILES)) as pool:
        libs = dict(zip(P_TILES, pool.map(lambda pt: load_kernel(pt)[0], P_TILES)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    h, p, n, chunk = 64, 64, 128, 64
    rows = []
    for s in SEQS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(1, s, h, p, generator=gen, device="cuda").to(dtype)
            dta = -0.1 * torch.randn(1, s, h, generator=gen, device="cuda").abs()
            B = torch.randn(1, s, n, generator=gen, device="cuda").to(dtype)
            C = torch.randn(1, s, n, generator=gen, device="cuda").to(dtype)
            yr = ssd_chunked(x, dta, B, C, chunk)[0].float()
            bound = 1e-5 if dtype == torch.float32 else 3e-2
            configs = [(pt, st) for pt in P_TILES for st in (1, 2)
                       if libs[pt].ssd_scan_smem_bytes(_DTYPES[dtype], n, chunk, st)
                       <= _SMEM_LIMIT]
            y = torch.empty_like(x)
            times = {}
            for cfg in configs:
                _launch(x, dta, B, C, y, chunk, *cfg)
                err = ((y.float() - yr).abs().max() / yr.abs().max()).item()
                if not err < bound:
                    raise SystemExit(f"tune: p_tile {cfg[0]} stages {cfg[1]} S={s} "
                                     f"{dtype}: max err / max|y| {err:.3e}")
            for order in (configs, configs[::-1]):
                for cfg in order:
                    times.setdefault(cfg, []).append(
                        _ms(lambda: _launch(x, dta, B, C, y, chunk, *cfg)))
            for (pt, st), ms in sorted(times.items(), key=lambda kv: min(kv[1])):
                smem = libs[pt].ssd_scan_smem_bytes(_DTYPES[dtype], n, chunk, st)
                row = dict(seq=s, dtype=str(dtype).replace("torch.", ""), p_tile=pt,
                           stages=st, ctas=-(-p // pt) * h, smem_bytes=smem, ms=ms)
                rows.append(row)
                print(f"# [tune ssd] S={s} {row['dtype']} p_tile {pt} stages {st} "
                      f"({row['ctas']} CTAs, {smem} B shared): "
                      + ", ".join(f"{t:.4f}" for t in ms) + " ms")
    print(smi)
    print(json.dumps({"ssd_scan_tune": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
