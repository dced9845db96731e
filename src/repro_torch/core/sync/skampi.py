"""SKaMPI clock synchronization (§4.1, Algorithms 7-8).

Offset-only, O(p) rounds: the root measures its clock offset to every other
rank with the ping-pong min/max-window technique (Cristian-style [18]) and
the offsets define a logical global clock. Very accurate immediately after
synchronization (Fig. 8) but drifts because no slope is learned (Fig. 9).
"""

from __future__ import annotations


from ..clocks import LinearModel
from ..simnet import SimNet
from .base import ClockSync, SyncResult, skampi_pingpong_adjusted

__all__ = ["SkampiSync"]


class SkampiSync(ClockSync):
    name = "skampi"

    def __init__(self, n_pingpongs: int = 100):
        self.n_pingpongs = n_pingpongs

    def synchronize(self, net: SimNet, ranks: list[int] | None = None,
                    device=None) -> SyncResult:
        ranks = list(range(net.p)) if ranks is None else ranks
        root = ranks[0]
        net.align(ranks)
        snap = net.elapsed_snapshot()
        msgs0 = net.msg_count

        models = {r: LinearModel(0.0, 0.0) for r in ranks}
        # COMPUTE_AND_SET_CLOCK_OFFSETS (Alg. 8): root pairs with each rank
        # in turn. (The per-pair MPI_Barrier of Alg. 8 line 5 is modeled by
        # the serialization of the pairs on the root's timeline.)
        for r in ranks:
            if r == root:
                continue
            diff = skampi_pingpong_adjusted(net, root, r, None, self.n_pingpongs)
            # diff ~= clock_r - clock_root  =>  normalize: local_r - diff.
            models[r] = LinearModel(0.0, diff)

        net.align(ranks)
        duration = net.max_elapsed_since(snap)
        p = net.p
        full = [models.get(r, LinearModel(0.0, 0.0)) for r in range(p)]
        return SyncResult(
            algorithm=self.name,
            models=full,
            initial_times=[0.0] * p,
            duration=duration,
            n_messages=net.msg_count - msgs0,
            params={"n_pingpongs": self.n_pingpongs},
        )
