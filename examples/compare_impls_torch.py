"""Fair comparison of two REAL implementations on the PyTorch port, the
paper's way (§6). The port of ``examples/compare_impls.py``.

Question: is the hand-written flash-attention kernel faster than its
plain PyTorch version on this card at seq 128/256? Answer it properly:
the *same* campaign spec runs against two
:class:`~repro_torch.campaign.TorchKernelBackend` configurations
(``impl="cuda"`` vs ``impl="ref"``), with launch epochs = cleared caches,
adaptive nrep, Tukey filtering, and Wilcoxon on per-epoch medians — not
a single-number eyeball. The inputs are float32 at head dim 64, so the
kernel is the f32 instance (3xTF32 on the tensor cores).

With ``--device cpu`` both arms run the plain version (the wrappers'
CPU path), so the verdict there says nothing about the kernel; on the
card the same script answers the real question.

    PYTHONPATH=src python examples/compare_impls_torch.py
    PYTHONPATH=src python examples/compare_impls_torch.py --device cpu
"""

import argparse

from repro_torch.campaign import Campaign, CampaignSpec, TorchKernelBackend
from repro_torch.core import (ExperimentDesign, TestCase, compare_tables,
                              format_comparison)

SEQS = (128, 256)
SHAPE = dict(batch=2, heads=4, kv_heads=2, head_dim=64)


def walkthrough(device: str = "cuda") -> dict:
    """Both campaigns at the reference's sizes; returns the rows, the table
    and the verdict lines."""
    spec = CampaignSpec(
        cases=[TestCase("flash_attention", s) for s in SEQS],
        design=ExperimentDesign(n_launch_epochs=5, nrep_min=5, nrep_max=30,
                                rel_ci_target=0.05, seed=7),
        name="flash-attn-vs-ref",
    )
    kernel = Campaign(spec, TorchKernelBackend(impl="cuda", device=device, **SHAPE)).run()
    ref = Campaign(spec, TorchKernelBackend(impl="ref", device=device, **SHAPE)).run()

    rows = compare_tables(kernel.table, ref.table)
    table = format_comparison(rows, "cuda", "ref")
    print(table)
    verdicts = []
    for r in rows:
        verdict = ("faster than" if r.verdict == "A<B" else
                   "slower than" if r.verdict == "A>B" else
                   "indistinguishable from")
        verdicts.append(f"verdict @ seq {r.case.msize}: cuda kernel is {verdict} "
                        f"the plain PyTorch version (p_less={r.p_a_less:.2e}, "
                        f"p_greater={r.p_a_greater:.2e})")
        print(verdicts[-1])
    return dict(rows=rows, table=table, verdicts=verdicts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return walkthrough(args.device)


if __name__ == "__main__":
    main()
