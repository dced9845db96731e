"""Cross-pod gradient compression with error feedback, on the PyTorch port.

Simulates the cross-pod gradient reduction of two pods in one process
(so one card runs it) with int8 blockwise quantization + error feedback,
and shows (a) ~4x wire-volume reduction, (b) training-equivalent
accumulated updates (the error-feedback residual stays bounded), and (c)
the decision made the paper's way — Wilcoxon on the loss trajectories of
compressed vs uncompressed runs. The port of ``examples/compressed_dp.py``;
the model runs on ``--device`` (the card by default) with the plain
attention, which autograd differentiates.

    PYTHONPATH=src python examples/compressed_dp_torch.py
    PYTHONPATH=src python examples/compressed_dp_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import wilcoxon_rank_sum
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import init_train_state
from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.optim import OptimizerConfig, adamw_update
from repro_torch.optim.compress import error_feedback_update
from repro_torch.runtime.trainer import to_device

CFG = ModelConfig(name="dp-demo", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                  dtype="float32")
OPT = OptimizerConfig(lr=2e-3, warmup_steps=5, weight_decay=0.0)
PODS = 2
STEPS = 20


def grads_of(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(CFG, model, batch, impl="ref")
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def run(compressed: bool, seed: int, device):
    state = init_train_state(init_params(CFG, device=device, seed=seed))
    model = state["params"]
    residuals = [None] * PODS
    sources = [SyntheticLM(DataConfig(vocab_size=CFG.vocab_size, seq_len=64,
                                      global_batch=4, seed=100 + p))
               for p in range(PODS)]
    losses, wire_bytes = [], 0
    for step in range(STEPS):
        pod_grads, pod_losses = [], []
        for p in range(PODS):
            loss, g = grads_of(model, to_device(sources[p].batch_at(step), device))
            pod_losses.append(float(loss))
            if compressed:
                comp, decomp, residuals[p] = error_feedback_update(g, residuals[p])
                wire_bytes += sum(q.numel() + s.numel() * 4 for q, s in comp.values())
                pod_grads.append(decomp)          # what crosses the DCN
            else:
                wire_bytes += sum(4 * t.numel() for t in g.values())
                pod_grads.append(g)
        # cross-pod mean (the DCN all-reduce)
        mean_g = {n: sum(pg[n] for pg in pod_grads) / PODS for n in pod_grads[0]}
        adamw_update(model, mean_g, state["opt"], OPT)
        losses.append(float(np.mean(pod_losses)))
    return np.array(losses), wire_bytes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    base_losses, base_bytes = run(False, seed=0, device=device)
    comp_losses, comp_bytes = run(True, seed=0, device=device)
    print(f"wire volume: fp32 {base_bytes/2**20:.1f} MiB -> "
          f"int8+ef {comp_bytes/2**20:.1f} MiB "
          f"({base_bytes/comp_bytes:.2f}x reduction)")
    print(f"final loss: fp32 {base_losses[-1]:.4f} vs "
          f"compressed {comp_losses[-1]:.4f}")
    res = wilcoxon_rank_sum(base_losses[-8:], comp_losses[-8:])
    print(f"Wilcoxon on last-8 losses: p={res.p_value:.3f}{res.stars or ' '}"
          f" -> {'indistinguishable' if res.p_value > 0.05 else 'different'}")
    if not comp_losses[-1] < comp_losses[0]:
        raise RuntimeError("the compressed run did not reduce loss")
    if not base_bytes / comp_bytes > 3.0:
        raise RuntimeError(f"wire reduction {base_bytes / comp_bytes:.2f}x, want > 3x")
    return dict(base_losses=base_losses, comp_losses=comp_losses,
                reduction=base_bytes / comp_bytes, p_value=res.p_value)


if __name__ == "__main__":
    main()
