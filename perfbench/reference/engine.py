"""One launch epoch of a simulated campaign, worked out again from its seeds.

The plain reference of what the program measures (§3.2-§3.3, §5): each
collective's cost model with its per-epoch bias, lognormal AR(1) noise and
tail and spike mixture; ``nrep`` calls under window-based synchronization,
where call ``i`` may start at the global time ``start + i * win`` and a
call that starts late or outlasts its window is discarded; and the
top-up of the discards by at most two further windows.

The draws follow the program's published stream: the host generator of
the cluster gives each window a seed and each collective its epoch bias,
and each window's noise comes from a ``torch.Generator`` on the device,
seeded from ``(window seed, term)``, at the bucketed length. The AR(1)
recurrence runs here in its plain serial form, so the durations agree with
the program's to rounding. The ``(rows, p)`` grids are plain PyTorch on
the device, float64 (``dtype=float32`` is the precision control). Nothing
here imports the program.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .cluster import Cluster, derive_stream

START_LATE = 1
TOOK_TOO_LONG = 2


def sync_of(name: str):
    """The reference's clock sync called ``name``: the function
    ``sync(cl, cfg, dtype=np.float64)`` of ``perfbench/reference/sync_<name>.py``,
    which synchronizes cluster ``cl`` and returns a
    :class:`~perfbench.reference.cluster.Sync`. Raises ``ValueError`` where
    there is no such file."""
    module = f"{__package__}.sync_{name}"
    if str(name).isidentifier():
        try:
            return importlib.import_module(module).sync
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    raise ValueError(f"the reference has no sync {name!r}: no perfbench/reference/sync_{name}.py")


def bucket(nrep: int) -> int:
    """Draw length of a window of ``nrep`` calls: the next power of two
    from 32 below 1024, ``nrep`` itself from there."""
    if nrep >= 1024:
        return nrep
    n = 32
    while n < nrep:
        n *= 2
    return n


def generator(device, *key) -> torch.Generator:
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def case_orders(design_seed: int, n_epochs: int, cases: list) -> list[list]:
    """Each epoch's case order, drawn up front from the design seed."""
    rng = np.random.default_rng(design_seed)
    return [[cases[i] for i in rng.permutation(len(cases))] for _ in range(n_epochs)]


class Op:
    """A collective's cost model ``alpha ceil(log2 p) + beta m + gamma``
    with its statistical structure; ``params`` is the configuration's entry."""

    def __init__(self, name: str, params: dict):
        self.name = name
        self.__dict__.update(params)
        self.ar_state = 0.0
        self.bias: float | None = None

    def base_time(self, p: int, msize: int) -> float:
        levels = max(1, int(np.ceil(np.log2(max(2, p)))))
        return self.alpha * levels + self.beta * self.msize_factor * msize + self.gamma

    def epoch_bias(self, cl: Cluster) -> float:
        if self.bias is None:
            self.bias = float(np.exp(derive_stream(cl.rng).normal(0.0, self.epoch_bias_sigma)))
        return self.bias


def ar1(eps: np.ndarray, coeff, state) -> np.ndarray:
    """``s_i = coeff * s_{i-1} + eps_i`` from ``s_{-1} = state``, one step
    at a time in the type of ``eps`` (``coeff`` and ``state`` given in it)."""
    out, s = [], state
    for e in eps:
        s = coeff * s + e
        out.append(s)
    return np.asarray(out, dtype=eps.dtype)


class Epoch:
    """A fresh cluster (seed ``seed0 + 1000 * epoch``), its clock sync (the
    configuration's ``sync``, :func:`sync_of`), and the collectives' state;
    :meth:`window` measures like the program's per-epoch engine."""

    def __init__(self, cfg: dict, seed0: int, epoch: int, device, dtype=torch.float64):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.cl = Cluster(cfg["p"], cfg["net"], cfg["clocks"], seed=seed0 + 1000 * epoch)
        self.sync = sync_of(cfg["sync"])(
            self.cl, cfg, dtype=np.float64 if dtype == torch.float64 else np.float32)
        self.win = cfg["win_size_us"] * 1e-6
        self.walking = cfg["clocks"]["rw_sigma"] > 0.0
        self.ops: dict[str, Op] = {}

    def op(self, name: str) -> Op:
        if name not in self.ops:
            self.ops[name] = Op(name, self.cfg["ops"][name])
        return self.ops[name]

    def _durations(self, op: Op, msize: int, n: int, nrep: int, seed: int):
        p, dev, dt = self.cl.p, self.device, self.dtype
        t0 = op.base_time(p, msize) * op.epoch_bias(self.cl)
        gen = generator(dev, seed, 0)
        eps = torch.empty(n, dtype=torch.float64, device=dev).normal_(
            0.0, op.noise_sigma, generator=gen)
        u_tail, u_mag, u_spike = (torch.empty(n, dtype=torch.float64, device=dev)
                                  .uniform_(generator=gen).to(dt) for _ in range(3))
        np_dt = np.float64 if dt == torch.float64 else np.float32
        s = ar1(eps.cpu().numpy().astype(np_dt), np_dt(op.autocorr), np_dt(op.ar_state))
        op.ar_state = float(s[nrep - 1])
        s = torch.from_numpy(s).to(dev)
        t = torch.tensor(t0, dtype=dt, device=dev) * torch.exp(s)
        mag = 1.0 + op.tail_shift * (0.7 + 0.6 * u_mag)
        t = torch.where(u_tail < op.tail_prob, t * mag, t)
        return torch.where(u_spike < op.spike_prob, t * op.spike_scale, t)

    def _paths(self):
        """Every rank's drift path as ``(p, L)`` node times (``inf`` past a
        rank's end), walk values and node counts, on the device."""
        paths = [c.path for c in self.cl.clocks]
        L = max(pth.t.size for pth in paths)
        T = np.full((len(paths), L), np.inf)
        X = np.zeros((len(paths), L))
        for i, pth in enumerate(paths):
            T[i, :pth.t.size], X[i, :pth.t.size] = pth.t, pth.x
        lens = torch.tensor([pth.t.size for pth in paths], device=self.device)[:, None]
        return (torch.from_numpy(T).to(self.device, self.dtype),
                torch.from_numpy(X).to(self.device, self.dtype), lens)

    def window(self, name: str, msize: int, nrep: int):
        """``nrep`` calls of ``name`` at ``msize`` bytes: the global-clock
        time of each call and its discard flags, as numpy arrays. Advances
        every host's true time to the end of call ``nrep - 1``."""
        cl, sync, win, dev, dt = self.cl, self.sync, self.win, self.device, self.dtype
        p = cl.p
        clocks = cl.clocks
        if self.walking:
            for c in clocks:
                c.drift_path(win)
        start_time = max(sync.global_time(cl, r) for r in range(p)) + win
        n = bucket(nrep)
        seed = int(cl.rng.integers(2**31))
        op = self.op(name)
        durations = self._durations(op, msize, n, nrep, seed)

        def col(v):
            return torch.tensor(np.asarray(v, dtype=np.float64), dtype=dt, device=dev)

        t0 = col(cl.t)
        off, skew = col([c.offset for c in clocks]), col([c.skew for c in clocks])
        scale = col([c.scale_error for c in clocks])
        slope, intercept, init = col(sync.slope), col(sync.intercept), col(sync.init)

        targets = (torch.tensor(start_time, dtype=dt, device=dev)
                   + win * torch.arange(n, dtype=dt, device=dev))
        raw = ((targets[:, None] + intercept) / (1.0 - slope) + init) / (1.0 + scale)
        if self.walking:
            last = start_time + win * (nrep - 1)
            for r, c in enumerate(clocks):
                c.cover_local(sync.local_deadline(r, last) / (1.0 + c.scale_error))
            T, X, lens = self._paths()
            rate = (1.0 + skew)[:, None]
            F = off[:, None] + rate * T + X
            q = raw.T.contiguous()
            idx = torch.searchsorted(F, q, right=True) - 1
            idx = torch.minimum(idx.clamp_min(0), lens - 2)
            x0, x1 = X.gather(1, idx), X.gather(1, idx + 1)
            deadline = (T.gather(1, idx) + (q - F.gather(1, idx))
                        / (rate + (x1 - x0) / clocks[0].path.dt)).T
        else:
            deadline = (raw - off) / (1.0 + skew)

        z = torch.empty((n, p), dtype=torch.float32, device=dev).normal_(
            generator=generator(dev, seed, 1))
        imb = torch.clamp_min(1.0 + op.rank_imbalance * z.to(dt), 0.25)
        span = durations[:, None] * imb
        e = span.amax(dim=1)
        dmax = deadline.amax(dim=1)
        # the calls' entry times: all ranks in at C_i + max(max t0, max_{j<=i} (dmax_j - C_j)),
        # C the running sum of the slowest ranks' spans, summed in order on the host
        host_e = e[:-1].cpu().numpy()
        C = torch.from_numpy(np.concatenate([np.zeros(1, host_e.dtype), np.cumsum(host_e)])).to(dev)
        all_in = C + torch.clamp_min(torch.cummax(dmax - C, dim=0).values, t0.max())
        end = all_in[:, None] + span
        prev_end = torch.cat([t0[None, :], end[:-1]], dim=0)
        start = torch.maximum(deadline, prev_end)
        late = (deadline <= prev_end).any(dim=1)

        if self.walking:
            peaks = torch.stack([start[:nrep].amax(dim=0), end[:nrep].amax(dim=0)])
            for c, a, b in zip(clocks, *peaks.cpu().numpy().astype(np.float64).tolist()):
                c.path.ensure(a)
                c.path.ensure(b)
            T, X, lens = self._paths()

        def to_global(t_true):
            local = off + (1.0 + skew) * t_true
            if self.walking:
                local = local + _interp(T, X, lens, t_true)
            adj = local * (1.0 + scale) - init
            return adj - (adj * slope + intercept)

        sg, eg = to_global(start), to_global(end)
        took = (eg > (targets + win)[:, None]).any(dim=1)
        errors = late.to(torch.int64) * START_LATE | took.to(torch.int64) * TOOK_TOO_LONG
        times = eg.amax(dim=1) - sg.amin(dim=1)
        cl.t[:] = end[nrep - 1].cpu().numpy().astype(np.float64)
        return (times[:nrep].cpu().numpy().astype(np.float64),
                errors[:nrep].cpu().numpy())

    def measure(self, name: str, msize: int, nrep: int):
        """A record: a first window of ``nrep`` calls and at most two more,
        each as large as the valid calls still missing. Returns the windows
        ``[(size, times, errors)]`` and the record's times: the valid ones,
        or the first ``nrep`` raw times when none is valid."""
        runs = []
        for _ in range(3):
            size = nrep - sum(int(np.count_nonzero(er == 0)) for _, _, er in runs)
            if size <= 0:
                break
            runs.append((size, *self.window(name, msize, size)))
        valid = np.concatenate([t[er == 0] for _, t, er in runs])
        record = valid if valid.size else np.concatenate([t for _, t, _ in runs])[:nrep]
        return runs, record

def _interp(T, X, lens, t_true):
    """The walk at true times ``(n, p)``: linear between the nodes, held at
    the first and last node outside them."""
    q = t_true.T.contiguous()
    j = torch.searchsorted(T, q, right=True) - 1
    jc = torch.minimum(j.clamp_min(0), lens - 2)
    t0, t1 = T.gather(1, jc), T.gather(1, jc + 1)
    x0, x1 = X.gather(1, jc), X.gather(1, jc + 1)
    out = (x1 - x0) / (t1 - t0) * (q - t0) + x0
    out = torch.where(t0 == q, x0, out)
    out = torch.where(j >= lens - 1, X.gather(1, lens - 1), out)
    out = torch.where(j < 0, X[:, :1], out)
    return out.T
