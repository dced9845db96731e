"""The reference's clock sync of a configuration with ``"sync": "hca"``:
HCA (§3.6) at the configuration's ``n_fitpts`` and ``n_exchanges``."""

from __future__ import annotations

import numpy as np

from .cluster import Cluster, Sync, hca


def sync(cl: Cluster, cfg: dict, dtype=np.float64) -> Sync:
    return hca(cl, cfg["n_fitpts"], cfg["n_exchanges"], dtype=dtype)
