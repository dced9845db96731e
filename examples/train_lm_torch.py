"""End-to-end training run on the PyTorch port: fault-tolerant,
instrumented, resumable.

Trains an LM on the deterministic synthetic pipeline with async
checkpointing, straggler monitoring and (optionally) an injected failure —
the supervisor restarts from the latest checkpoint and the loss trajectory
matches an uninterrupted run. The port of ``examples/train_lm.py``; the
weights are drawn on ``--device`` (the card by default), the attention
runs the plain path, which autograd differentiates.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 120 --preset small
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --preset 100m \\
        --batch 8 --seq 512           # ~110M params
    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --fail-at 25
    PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --steps 30 --device cpu
"""

import argparse
import contextlib
import tempfile

import numpy as np

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.core.stats import mean_confidence_interval, tukey_filter
from repro_torch.data import DataConfig
from repro_torch.models import ModelConfig
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig, run_supervised

PRESETS = {
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab_size=512),
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                  vocab_size=4096),          # ~5M params
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab_size=32768),  # ~110M params
}


def main(argv=None) -> dict:
    """Run the drill; returns ``run_supervised``'s result with the
    trainer's step times, after the checks the reference example makes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (restart drill)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with contextlib.ExitStack() as stack:
        if args.ckpt_dir is None:
            args.ckpt_dir = stack.enter_context(tempfile.TemporaryDirectory())
        return _drill(args)


def _drill(args) -> dict:
    cfg = ModelConfig(name=f"lm-{args.preset}", family="dense",
                      dtype="float32", **PRESETS[args.preset])
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    trainer = Trainer(
        cfg, data,
        opt_cfg=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                decay_steps=args.steps),
        trainer_cfg=TrainerConfig(total_steps=args.steps, save_every=20,
                                  log_every=10),
        ckpt_cfg=CheckpointConfig(directory=args.ckpt_dir, keep=2),
        device=args.device)

    failure = FailureInjector((args.fail_at,)) if args.fail_at else None
    out = run_supervised(trainer, failure)

    losses = out["losses"]
    kept = tukey_filter(np.array(trainer.step_times[5:]))
    m, lo, hi = mean_confidence_interval(kept)
    print(f"\ndone: {out['final_step']} steps, restarts={out['restarts']}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    print(f"step time (Tukey-filtered): {m*1e3:.1f}ms "
          f"[{lo*1e3:.1f}, {hi*1e3:.1f}] 95% CI")
    if out["stragglers"]:
        print(f"straggling steps flagged: {out['stragglers']}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce loss")
    out["step_times"] = list(trainer.step_times)
    return out


if __name__ == "__main__":
    main()
