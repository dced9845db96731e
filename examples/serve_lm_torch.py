"""Serving example on the PyTorch port: batched prefill + decode with measured
token latency.

Draws a model's weights from a seed (a smoke config, or the full config
with ``--full``), prefills a batch of random prompts, decodes N tokens per
request greedily, and reports per-token latency with the paper's
statistics (Tukey filter + CI) — the port of ``examples/serve_lm.py``. On
the card attention runs the hand-written flash kernels.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-2b --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-2b --full \\
        --prompt-len 128 --tokens 32          # one GPU, bf16 weights
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.stats import mean_confidence_interval, tukey_filter
from repro_torch.models import decode_step, init_params, prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, model, *, batch: int, prompt_len: int, tokens: int, seed: int = 0) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``tokens`` steps greedily. Host-clock times end in a device
    synchronisation. Returns the prefill time, the per-step latencies (the
    first two, warm-up, dropped), their Tukey-filtered mean and 95% CI,
    the generated ids, the last logits and the cache."""
    device = model.embed.device
    gen = np.random.default_rng(seed)
    prompts = torch.from_numpy(gen.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, model, prompts, max_len=prompt_len + tokens + 1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = logits[:, -1:].argmax(dim=-1)
    lat, generated = [], [tok]
    for _ in range(tokens):
        t0 = time.perf_counter()
        logits, cache = decode_step(cfg, model, cache, tok)
        tok = logits.argmax(dim=-1)
        _sync(device)
        lat.append(time.perf_counter() - t0)
        generated.append(tok)
    lat = np.array(lat[2:])          # drop warm-up steps
    kept = tukey_filter(lat)
    m, lo, hi = mean_confidence_interval(kept)
    return dict(prefill_s=t_prefill, prefill_tok_s=batch * prompt_len / t_prefill,
                latencies=lat, kept=kept, mean=m, lo=lo, hi=hi,
                decode_tok_s=batch / m, out=torch.cat(generated, dim=1).cpu(),
                logits=logits, cache=cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full config (get_config), not its smoke one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    model = init_params(cfg, device=args.device, seed=args.seed)
    r = serve(cfg, model, batch=args.batch, prompt_len=args.prompt_len,
              tokens=args.tokens, seed=args.seed)
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{r['prefill_s'] * 1e3:.1f}ms ({r['prefill_tok_s']:.0f} tok/s)")
    print(f"decode: {args.tokens} steps x {args.batch} seqs")
    print(f"per-step latency (Tukey-filtered): {r['mean'] * 1e3:.2f}ms "
          f"[{r['lo'] * 1e3:.2f}, {r['hi'] * 1e3:.2f}] 95% CI "
          f"-> {r['decode_tok_s']:.0f} tok/s")
    out = r["out"]
    if out.shape != (args.batch, args.tokens + 1):
        raise RuntimeError(f"generated ids have shape {tuple(out.shape)}")
    if not torch.isfinite(r["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    print("sample token ids:", out[0, :12].numpy())


if __name__ == "__main__":
    main()
