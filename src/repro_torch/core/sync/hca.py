"""HCA clock synchronization — the paper's contribution (§4.4, Algs. 2-4).

HCA (Hunold / Carpen-Amarie) combines:

  * the *linear drift model* of Jones & Koenig (slope + intercept learned
    from ping-pong fitpoints), so the global clock stays accurate over long
    measurement horizons, with
  * the *hierarchical* O(log p) pair structure of Netgauge, so the
    synchronization phase scales,
  * transitive merging of linear models (MERGE_LMS, the exact composition —
    see :meth:`repro_torch.core.clocks.LinearModel.merge`),
  * intercept re-anchoring with the SKaMPI ping-pong offset (the regression
    intercept has a ~100 ms-wide confidence interval, §4.4, so it is
    discarded and recomputed from a direct offset measurement).

Two variants, as in the paper:

  * ``HCA``  (first approach): slopes hierarchically in O(log p) rounds,
    intercepts linearly — root re-anchors every rank in O(p) rounds.
  * ``HCA2`` (second approach, ``hierarchical_intercepts=True``): intercepts
    are re-anchored per-pair and *merged* hierarchically in O(log p) rounds;
    faster, but the intercept error now accumulates along the tree (Fig. 9
    shows HCA2 offsets larger than HCA at p = 512).
"""

from __future__ import annotations

import math


from ..clocks import LinearModel, linear_fit
from ..simnet import SimNet
from .base import ClockSync, SyncResult, compute_rtt, skampi_pingpong_adjusted
from .jk import collect_fitpoints_batch

__all__ = ["HCASync", "learn_model_hca"]


def learn_model_hca(
    net: SimNet,
    ref: int,
    client: int,
    rtt: float,
    n_fitpts: int,
    n_exchanges: int,
    initial_times: list[float],
) -> LinearModel:
    """LEARN_MODEL_HCA (Alg. 4): drift model of ``client`` relative to
    ``ref`` on *adjusted* clocks, via linear regression over fitpoints.

    The ``n_fitpts x n_exchanges`` ping-pong sweep runs through the
    vectorized engine (:func:`repro_torch.core.sync.jk.collect_fitpoints_batch`)
    in one shot — the pair's fitpoints are back-to-back in Alg. 4, so the
    merged sweep has the same timeline as per-fitpoint round-trips."""
    xs, ys = collect_fitpoints_batch(
        net, client, ref, rtt, n_fitpts, n_exchanges,
        initial_times=initial_times,
    )
    return linear_fit(xs, ys)


class HCASync(ClockSync):
    name = "hca"

    def __init__(
        self,
        n_fitpts: int = 100,
        n_exchanges: int = 10,
        hierarchical_intercepts: bool = False,
        intercept_pingpongs: int = 100,
    ):
        self.n_fitpts = n_fitpts
        self.n_exchanges = n_exchanges
        self.hierarchical_intercepts = hierarchical_intercepts
        self.intercept_pingpongs = intercept_pingpongs
        if hierarchical_intercepts:
            self.name = "hca2"

    # -- helpers ------------------------------------------------------------
    def _set_intercept(
        self,
        net: SimNet,
        lm: LinearModel,
        client: int,
        ref: int,
        initial_times: list[float],
    ) -> LinearModel:
        """COMPUTE_AND_SET_INTERCEPT (Alg. 4 lines 22-28): re-anchor the
        intercept from a SKaMPI offset measured at a known adjusted time."""
        diff = skampi_pingpong_adjusted(
            net, ref, client, initial_times, self.intercept_pingpongs
        )
        diff_timestamp = net.local_time(client) - initial_times[client]
        return lm.with_intercept_from_offset(diff, diff_timestamp)

    # -- main ---------------------------------------------------------------
    def synchronize(self, net: SimNet, ranks: list[int] | None = None) -> SyncResult:
        ranks = list(range(net.p)) if ranks is None else ranks
        p = len(ranks)
        root = ranks[0]
        net.align(ranks)
        snap = net.elapsed_snapshot()
        msgs0 = net.msg_count

        # Alg. 2/3 line 1: logical local clocks start at zero.
        initial_times = [0.0] * net.p
        for r in ranks:
            initial_times[r] = net.local_time(r)

        maxpower = 2 ** int(math.floor(math.log2(p))) if p > 1 else 1

        # subtree[i]: models of members (local indices) relative to local
        # index i, built bottom-up; mirrors the l_model tables of Alg. 3.
        subtree: dict[int, dict[int, LinearModel]] = {
            i: {i: LinearModel(0.0, 0.0)} for i in range(p)
        }

        # ---- SYNC_CLOCKS_POW2: hierarchical slope (and HCA2: intercept) ----
        rnd = 1
        while 2 ** rnd <= maxpower:
            half = 2 ** (rnd - 1)
            for ref_i in range(0, maxpower, 2 ** rnd):
                cli_i = ref_i + half
                ref_r, cli_r = ranks[ref_i], ranks[cli_i]
                rtt = compute_rtt(net, ref_r, cli_r)
                lm = learn_model_hca(
                    net, ref_r, cli_r, rtt,
                    self.n_fitpts, self.n_exchanges, initial_times,
                )
                if self.hierarchical_intercepts:
                    lm = self._set_intercept(net, lm, cli_r, ref_r, initial_times)
                # Client ships its model table one level up (one message).
                net.transfer(cli_r, ref_r)
                for m, sub_lm in subtree[cli_i].items():
                    subtree[ref_i][m] = LinearModel.merge(lm, sub_lm)
            rnd += 1

        # ---- SYNC_CLOCKS_REMAINING: non-power-of-two ranks, one round ------
        for j in range(p - maxpower):
            q_i = maxpower + j
            ref_i = j
            q_r, ref_r = ranks[q_i], ranks[ref_i]
            rtt = compute_rtt(net, ref_r, q_r)
            lm = learn_model_hca(
                net, ref_r, q_r, rtt, self.n_fitpts, self.n_exchanges, initial_times
            )
            if self.hierarchical_intercepts:
                lm = self._set_intercept(net, lm, q_r, ref_r, initial_times)
            net.transfer(q_r, ranks[0])  # gather on root (sub-communicator)
            subtree[0][q_i] = LinearModel.merge(subtree[0][ref_i], lm)

        # ---- models now live on root; scatter (Alg. 2 line 5) --------------
        models = [LinearModel(0.0, 0.0) for _ in range(net.p)]
        for i, r in enumerate(ranks):
            models[r] = subtree[0].get(i, LinearModel(0.0, 0.0))

        # ---- first approach: linear intercept re-anchoring (O(p)) ----------
        if not self.hierarchical_intercepts:
            for i, r in enumerate(ranks):
                if r == root:
                    continue
                models[r] = self._set_intercept(
                    net, models[r], r, root, initial_times
                )

        net.align(ranks)  # MPI_BARRIER of Alg. 2 line 7
        duration = net.max_elapsed_since(snap)
        return SyncResult(
            algorithm=self.name,
            models=models,
            initial_times=initial_times,
            duration=duration,
            n_messages=net.msg_count - msgs0,
            params={
                "n_fitpts": self.n_fitpts,
                "n_exchanges": self.n_exchanges,
                "hierarchical_intercepts": self.hierarchical_intercepts,
            },
        )
