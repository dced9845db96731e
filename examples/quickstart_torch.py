"""Quickstart on the PyTorch port: the paper's methodology in 60 lines.
The port of ``examples/quickstart.py``.

Synchronize a (simulated) 16-host cluster with HCA, measure a collective
under window-based sync vs. a skewed library barrier, then compare two
"MPI libraries" the statistically sound way — as two *campaigns* on the
pluggable measurement-backend API, with adaptive nrep and a persistent
result store. The clocks and the sync run on the host in numpy, as in
the reference (the same seed prints the same HCA lines); every duration
is drawn through ``sim_scan`` on ``--device`` (the card by default).
``--engine batch`` draws every duration from the host's generator in the
reference's order (its scan still runs in ``sim_scan`` on the card), so
that on the CPU the window and barrier lines are the reference's.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --engine batch
"""

import argparse
import os
import tempfile

import numpy as np

from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
from repro_torch.core import (
    ExperimentDesign, SimNet, TestCase, compare_tables, format_comparison,
    make_op, make_sync, run_barrier_timed, run_windowed, true_offsets,
)


def walkthrough(device: str = "cuda", engine: str = "torch") -> dict:
    """Steps 1-3 of the reference at its sizes, on ``engine`` (``"torch"``,
    the device engine, or ``"batch"``, the reference's draws). Returns the
    printed HCA lines, the two measurements and the comparison rows."""
    # --- 1. drift-corrected clock synchronization (HCA, §4.4) -------------
    net = SimNet(16, seed=0)
    sync = make_sync("hca", n_fitpts=200, n_exchanges=40).synchronize(net)
    hca = [f"HCA sync: {sync.duration:.3f}s, "
           f"max offset {np.abs(true_offsets(net, sync))[1:].max()*1e6:.2f}us"]
    print(hca[0])
    net.sleep_all(10.0)
    hca.append(f"  after 10s of drift: "
               f"{np.abs(true_offsets(net, sync))[1:].max()*1e6:.2f}us (still synced)")
    print(hca[1])

    # --- 2. window-based vs barrier-based measurement (§4.6) ---------------
    op = make_op("allreduce")
    wr = run_windowed(net, sync, op, msize=8192, nrep=200, win_size=400e-6,
                      device=device, engine=engine)
    net2 = SimNet(16, seed=0)
    br = run_barrier_timed(net2, op, 8192, 200, barrier_exit_skew=40e-6,
                           device=device, engine=engine)
    print(f"windowed global time : {wr.valid_times.mean()*1e6:8.2f}us "
          f"(invalid {wr.invalid_fraction*100:.1f}%)")
    print(f"barrier local-max    : {br.times_local.mean()*1e6:8.2f}us "
          f"(includes ~40us library barrier skew!)")

    # --- 3. statistically sound comparison, the campaign way (§6) ----------
    # One spec; two backends modeling two "MPI libraries". Adaptive nrep:
    # each case keeps sampling until its mean is known to ~3%, capped at
    # 200 reps.
    spec = CampaignSpec(
        cases=[TestCase("allreduce", m) for m in (256, 4096)],
        design=ExperimentDesign(n_launch_epochs=10, nrep_min=30, nrep_max=200,
                                rel_ci_target=0.03, seed=42),
        name="quickstart",
    )
    lib_a = TorchSimBackend(p=8, seed0=100, op_kw=dict(gamma=2e-6), device=device,
                            engine=engine)
    lib_b = TorchSimBackend(p=8, seed0=900, op_kw=dict(gamma=2e-6, alpha=3.8e-6),
                            device=device, engine=engine)

    with tempfile.TemporaryDirectory() as td:
        store_a = ResultStore(os.path.join(td, "libA.jsonl"))
        store_b = ResultStore(os.path.join(td, "libB.jsonl"))
        res_a = Campaign(spec, lib_a, store_a).run()
        Campaign(spec, lib_b, store_b).run()
        used = [r.meta["nrep_used"] for r in res_a.records]
        print(f"\nadaptive nrep: {min(used)}..{max(used)} reps/case "
              f"(cap 200); store holds {len(store_a.records())} cells "
              f"under fingerprint {res_a.fingerprint}")

        # a second run against the same store would resume, not re-measure;
        # compare_tables reads the persisted campaigns directly.
        rows = compare_tables(store_a, store_b)
        print("\nWilcoxon comparison over 10 launch epochs each:")
        print(format_comparison(rows, "libA", "libB"))
    return dict(hca=hca, windowed_mean=float(wr.valid_times.mean()),
                invalid_fraction=wr.invalid_fraction,
                barrier_mean=float(br.times_local.mean()), rows=rows,
                nrep_used=used)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--engine", default="torch", choices=("torch", "batch"),
                    help="torch (default: draws on the device) or batch (the "
                         "reference's draws, in its order)")
    args = ap.parse_args(argv)
    return walkthrough(args.device, args.engine)


if __name__ == "__main__":
    main()
