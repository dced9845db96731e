"""A group of ``torch.distributed`` ranks driven by the measuring process.

The JAX package needs nothing like this: ``jax.pmap`` drives every device
of its mesh from one process. ``torch.distributed`` needs one process per
rank, so :class:`~repro_torch.campaign.TorchCollectiveBackend` drives a
:class:`RankGroup`: ``n`` rank processes that join one process group and
answer a small command set over one pipe each (``build``, ``check``,
``measure``, ``close``).

* **Start.** The ranks fork from a *fork server* that preloads torch and
  this module, never from the measuring process, which may hold a CUDA
  context (and, in the tests, JAX's threads). Each group meets through a
  ``file://`` rendezvous in a fresh temporary directory, so no TCP port
  is picked and concurrent groups cannot collide. On CUDA, rank ``r``
  runs on device ``r % torch.cuda.device_count()``: every rank shares
  device 0 under gloo on one card.
* **Faults raise and leave nothing running.** Every reply is awaited at
  most ``timeout_s``. A rank that raised (its traceback is carried into
  the message), died or is past its deadline raises ``RuntimeError`` in
  the parent, naming the rank, and the whole group is killed and joined.
  There is no retry and no fallback. ``close()`` ends the group politely;
  a ``weakref.finalize`` ends it if its owner forgets; a rank whose pipe
  closes (its parent died) exits.
* **Ranks outlive no fleet attempt.** A fleet attempt that starts groups
  names a file (:func:`log_ranks`); each group appends every rank's
  process id and start time there as the rank starts, and its start-up
  once every rank has replied, so the scheduler can find and end ranks
  that an attempt left behind when it crashed or was killed
  (:func:`read_rank_log`, :func:`rank_alive`): they are children of the
  attempt's fork server, not of the attempt.
* **The plain version.** :func:`expected_collective` is what each rank's
  output must be, given the reference's inputs (rank ``r`` holds ``r``
  in every element); each rank holds a newly built case against it.

``all_gather`` writes into one flat tensor through
``dist.all_gather_single`` where torch has it (2.13 deprecates
``all_gather_into_tensor`` in its favour) and ``all_gather_into_tensor``
otherwise (torch 2.11 has no ``all_gather_single``); the two take the
same arguments.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback
import weakref

import numpy as np
import torch

from ..simengine import resolve_device

__all__ = ["RankGroup", "ensure_ranks", "resolve_dist_backend",
           "expected_collective", "log_ranks", "read_rank_log", "rank_alive",
           "COLLECTIVES"]

#: The collectives a rank runs, by the reference's case names.
COLLECTIVES = ("psum", "all_gather", "all_to_all")

#: What the fork server imports once, so each rank forks with them loaded
#: (neither initialises CUDA on import).
_PRELOAD = ["torch", "torch.distributed", "repro_torch.campaign.ranks"]


#: Where this process's groups log their ranks (:func:`log_ranks`).
_rank_log: str | None = None


def log_ranks(path: str | None) -> None:
    """From now on, every :class:`RankGroup` this process starts appends
    a line ``rank <pid> <start time>`` to ``path`` as each rank starts,
    and ``group <start-up s>`` once all have replied (``None`` stops it).
    The start time, in clock ticks since boot, tells a rank from a later
    process that reuses its id."""
    global _rank_log
    _rank_log = path


def _log(line: str) -> None:
    if _rank_log is not None:
        with open(_rank_log, "a") as f:
            f.write(line + "\n")


def _proc_stat(pid: int) -> tuple[str, str] | None:
    """``(state, start time)`` of process ``pid`` from ``/proc``, or
    ``None`` when there is no such process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return fields[0], fields[19]


def rank_alive(pid: int, start: str | None = None) -> bool:
    """Whether process ``pid`` still runs: it exists, is not a zombie (an
    exited rank waiting for its parent, the fork server, to reap it) and,
    where ``start`` is given, started at that time."""
    stat = _proc_stat(pid)
    return stat is not None and stat[0] not in "ZX" and start in (None, stat[1])


def read_rank_log(path) -> tuple[list[tuple[int, str]], list[float]]:
    """What :func:`log_ranks` wrote to ``path``: the ranks' ``(pid, start
    time)`` pairs and the groups' start-ups [s]; both empty when there is
    no such file."""
    ranks, startups = [], []
    try:
        with open(path) as f:
            for line in f:
                kind, *fields = line.split() or ("",)
                if kind == "rank":
                    ranks.append((int(fields[0]), fields[1]))
                elif kind == "group":
                    startups.append(float(fields[0]))
    except FileNotFoundError:
        pass
    return ranks, startups


def resolve_dist_backend(device, dist_backend: str | None = None) -> str:
    """``dist_backend``, or the default for ``device``: NCCL on CUDA,
    gloo on the CPU."""
    if dist_backend is not None:
        return dist_backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_ranks(n: int, device="cuda", dist_backend: str | None = None) -> int:
    """The port's counterpart of ``ensure_host_devices``: ``n`` when the
    port can run ``n`` ranks of ``dist_backend`` on ``device``, else an
    error with the reason; nothing is started.

    ``dist_backend=None`` means NCCL on CUDA and gloo on the CPU; gloo
    with CUDA tensors runs only when asked for by name. NCCL refuses two
    ranks on one device, so it takes at most ``torch.cuda.device_count()``
    ranks. ``device="cuda"`` without CUDA raises ``RuntimeError``.
    """
    dev = resolve_device(device)
    backend = resolve_dist_backend(dev, dist_backend)
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"ensure_ranks: need n >= 1 ranks, got {n!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("ensure_ranks: NCCL runs on CUDA tensors only; "
                             "use dist_backend='gloo' on the CPU")
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(
                f"ensure_ranks: {n} NCCL ranks asked for, {have} CUDA "
                f"device(s) present: NCCL refuses two ranks on one device "
                f"(ask for gloo by name to share a device)")
        if not torch.distributed.is_nccl_available():
            raise ValueError("ensure_ranks: this torch has no NCCL")
    elif backend == "gloo":
        if not torch.distributed.is_gloo_available():
            raise ValueError("ensure_ranks: this torch has no gloo")
    else:
        raise ValueError(f"ensure_ranks: dist_backend must be 'nccl' or "
                         f"'gloo', got {backend!r}")
    return n


def expected_collective(op: str, rank: int, n: int, count: int,
                        dtype) -> torch.Tensor:
    """The output rank ``rank`` of an ``n``-rank ``op`` must hold when
    each rank ``r`` put ``r`` in all ``count`` elements of its input (the
    reference's ``jnp.zeros(shape) + jnp.arange(n)``), in the shape the
    reference's ``pmap`` gives each device: ``psum`` ``(count,)`` holding
    ``n(n-1)/2``; ``all_gather`` ``(n, count)``, row ``j`` holding ``j``;
    ``all_to_all`` ``(n, count // n)``, row ``j`` holding ``j``. The
    outputs do not depend on ``rank`` for these inputs; it is checked to
    lie in the group. On the CPU."""
    if not 0 <= rank < n:
        raise ValueError(f"expected_collective: rank {rank} outside 0..{n - 1}")
    if op == "psum":
        return torch.full((count,), n * (n - 1) / 2, dtype=dtype)
    rows = torch.arange(n, dtype=dtype)[:, None]
    if op == "all_gather":
        return rows.expand(n, count).clone()
    if op == "all_to_all":
        return rows.expand(n, count // n).clone()
    raise ValueError(f"expected_collective: unknown collective {op!r}; "
                     f"one of {COLLECTIVES}")


# ---------------------------------------------------------------------------
# Inside a rank
# ---------------------------------------------------------------------------

class _Term:
    """One collective of a case on one rank: its input, its output and its
    process group (``None`` for the whole group)."""

    def __init__(self, op: str, count: int, tn: int, group, rank: int,
                 dev: torch.device, dtype):
        import torch.distributed as dist

        self.op, self.count, self.tn, self.group = op, count, tn, group
        self.rank = rank
        if op == "psum":
            self.x = torch.full((count,), rank, dtype=dtype, device=dev)
            self.out = torch.empty_like(self.x)
        elif op == "all_gather":
            self.x = torch.full((count,), rank, dtype=dtype, device=dev)
            self.out = torch.empty(tn * count, dtype=dtype, device=dev)
        elif op == "all_to_all":
            # the split axis is the group size: (tn, count // tn) per rank
            self.x = torch.full((tn, count // tn), rank, dtype=dtype,
                                device=dev)
            self.out = torch.empty_like(self.x)
        else:
            raise ValueError(f"unknown collective {op!r}; one of "
                             f"{COLLECTIVES}")
        self._gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor

    def reset(self) -> None:
        """``all_reduce`` works in place: restore its input, untimed."""
        if self.op == "psum":
            self.out.copy_(self.x)

    def run(self) -> None:
        import torch.distributed as dist

        if self.op == "psum":
            dist.all_reduce(self.out, group=self.group)
        elif self.op == "all_gather":
            self._gather(self.out, self.x, group=self.group)
        else:
            dist.all_to_all_single(self.out, self.x, group=self.group)

    def output(self) -> torch.Tensor:
        """The output in the reference's per-device shape."""
        if self.op == "all_gather":
            return self.out.view(self.tn, self.count)
        return self.out


class _Rank:
    """A rank's state between commands: its device, process group,
    subgroups (one per size, made by every rank in the same order) and
    built cases."""

    def __init__(self, rank: int, n: int, device: str, dist_backend: str,
                 rdv: str, timeout_s: float):
        import torch.distributed as dist

        self.rank, self.n, self.dist_backend = rank, n, dist_backend
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            self.dev = torch.device("cuda", torch.cuda.current_device())
        else:
            self.dev = torch.device("cpu")
        # twice the parent's deadline, so that the parent, not a rank's
        # own timeout, names a rank that hangs
        dist.init_process_group(
            dist_backend, init_method=rdv, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=2 * timeout_s))
        self.groups: dict[int, object] = {}
        self.cases: dict[str, list] = {}
        self.barrier()

    def fence(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.dist_backend == "nccl":
            dist.barrier(device_ids=[self.dev.index])
        else:
            dist.barrier()

    def run_once(self, terms) -> None:
        for t in terms:
            if t is not None:
                t.reset()
        for t in terms:
            if t is not None:
                t.run()
        self.fence()

    def build(self, key: str, terms, dtype: str) -> None:
        """Make the case's tensors and subgroups, run it once untimed and
        hold every output against :func:`expected_collective`."""
        import torch.distributed as dist

        dt = getattr(torch, dtype)
        built = []
        for op, count, tn in terms:
            if tn < self.n and tn not in self.groups:
                self.groups[tn] = dist.new_group(list(range(tn)))
            if self.rank >= tn:
                built.append(None)
                continue
            built.append(_Term(op, count, tn, self.groups.get(tn), self.rank,
                               self.dev, dt))
        self.run_once(built)
        for t in built:
            if t is None:
                continue
            want = expected_collective(t.op, t.rank, t.tn, t.count, dt)
            got = t.output().cpu()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise RuntimeError(
                    f"rank {self.rank}: {t.op} over {t.tn} ranks of "
                    f"{t.count} {dtype} differs from expected_collective in "
                    f"{bad} of {want.numel()} elements")
        self.cases[key] = built

    def check(self, key: str) -> list:
        """Run the case once untimed; each term's output on the host
        (``None`` where this rank is outside the term)."""
        terms = self.cases[key]
        self.run_once(terms)
        return [None if t is None else t.output().cpu().float().numpy()
                for t in terms]

    def measure(self, key: str, nrep: int, warmup: int) -> np.ndarray:
        """``warmup`` untimed, then ``nrep`` timed repetitions: all ranks
        meet at a barrier, then each times its terms on its own clock,
        fenced on its device; a rank outside every term records 0."""
        terms = self.cases[key]
        mine = [t for t in terms if t is not None]
        local = np.zeros(nrep)
        for i in range(warmup + nrep):
            for t in mine:
                t.reset()
            self.fence()
            self.barrier()
            self.fence()                # an NCCL barrier is device work
            if not mine:
                continue
            t0 = time.perf_counter_ns()
            for t in mine:
                t.run()
            self.fence()
            t1 = time.perf_counter_ns()
            if i >= warmup:
                local[i - warmup] = (t1 - t0) * 1e-9
        return local


def _rank_main(rank: int, n: int, device: str, dist_backend: str, rdv: str,
               timeout_s: float, conn) -> None:
    """A rank process: join the group, then answer commands until
    ``close`` or until the parent's end of the pipe closes."""
    try:
        me = _Rank(rank, n, device, dist_backend, rdv, timeout_s)
        conn.send(("ok", os.getpid()))
        while True:
            try:
                cmd, *args = conn.recv()
            except EOFError:            # the parent is gone
                os._exit(0)
            if cmd == "close":
                import torch.distributed as dist

                dist.destroy_process_group()
                conn.send(("ok", None))
                os._exit(0)
            conn.send(("ok", getattr(me, cmd)(*args)))
    except BaseException:               # noqa: BLE001 — reported, then exit
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        os._exit(1)


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

def _stop(procs: list, conns: list, tmpdir: str) -> None:
    """Kill and join every rank that is still running, close the pipes
    and remove the rendezvous directory."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10.0)
    for c in conns:
        c.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class RankGroup:
    """``n`` rank processes in one ``torch.distributed`` process group.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``;
    ``dist_backend=None`` picks NCCL on CUDA and gloo on the CPU
    (:func:`ensure_ranks` refuses what cannot run, before anything
    starts). ``timeout_s`` bounds every wait for the ranks' replies; the
    process group's own timeout is twice it. ``startup_s`` is the wall from the
    first rank's start to every rank's reply after its first barrier;
    ``pids`` are the ranks' process ids.

    A daemonic process cannot start children, so a group cannot start
    there: that raises. A sweep's pool workers and a fleet's attempts are
    not daemonic, so each of them starts its own groups.
    """

    def __init__(self, n: int, device="cuda", dist_backend: str | None = None,
                 timeout_s: float = 60.0):
        self.n = ensure_ranks(n, device, dist_backend)
        dev = resolve_device(device)
        self.device = dev.type
        self.dist_backend = resolve_dist_backend(dev, dist_backend)
        self.timeout_s = float(timeout_s)
        if mp.current_process().daemon:
            raise RuntimeError(
                "RankGroup: a daemonic process cannot start rank processes; "
                "run the collective backend in a non-daemonic process")
        self.built: set[str] = set()
        self._procs: list = []
        self._conns: list = []
        self._tmpdir = tempfile.mkdtemp(prefix="ranks-")
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, self._tmpdir)
        # a fork server is a fresh interpreter started with this sys.path,
        # so a rank never inherits a CUDA context
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(_PRELOAD)
        rdv = "file://" + os.path.join(self._tmpdir, "rdv")
        t0 = time.perf_counter()
        try:
            for r in range(self.n):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_rank_main, name=f"rank-{r}", daemon=True,
                    args=(r, self.n, self.device, self.dist_backend, rdv,
                          self.timeout_s, child))
                self._conns.append(parent)
                proc.start()
                self._procs.append(proc)
                child.close()
                if _rank_log is not None:
                    stat = _proc_stat(proc.pid)
                    _log(f"rank {proc.pid} {stat[1] if stat else '-'}")
        except BaseException:
            self._finalizer()
            raise
        self.pids = self._gather("start")
        self.startup_s = time.perf_counter() - t0
        _log(f"group {self.startup_s!r}")

    # -- commands ------------------------------------------------------------

    def build(self, key: str, terms, dtype: str) -> None:
        """Build case ``key`` on every rank: ``terms`` is a list of
        ``(op, count, group_size)``, run in order inside one timed region,
        each over ranks ``0..group_size-1``. Each rank holds the outputs
        against :func:`expected_collective`."""
        self._call("build", key, [tuple(t) for t in terms], dtype)
        self.built.add(key)

    def check(self, key: str) -> list:
        """Run case ``key`` once untimed: per rank, each term's output as
        a float32 numpy array in the reference's per-device shape, or
        ``None`` where the rank is outside the term."""
        return self._call("check", key)

    def measure(self, key: str, nrep: int, warmup: int = 0) -> np.ndarray:
        """``(n, nrep)`` local times [s]: each rank's own clock around its
        terms after a barrier of the whole group, fenced on its device."""
        return np.stack(self._call("measure", key, int(nrep), int(warmup)))

    def close(self) -> None:
        """End the group: every rank destroys its process group and
        exits; any rank still running after ``timeout_s`` is killed."""
        if not self._finalizer.alive:
            return
        try:
            self._call("close")
            for p in self._procs:
                p.join(self.timeout_s)
        finally:
            self._finalizer()

    @property
    def alive(self) -> bool:
        return self._finalizer.alive

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- plumbing ------------------------------------------------------------

    def _fail(self, what: str):
        self._finalizer()
        raise RuntimeError(f"RankGroup ({self.n} {self.dist_backend} ranks "
                           f"on {self.device}): {what}")

    def _call(self, cmd: str, *args) -> list:
        if not self._finalizer.alive:
            raise RuntimeError(f"RankGroup: {cmd!r} on a closed group")
        for r, proc in enumerate(self._procs):
            if proc.exitcode is not None:
                self._fail(f"rank {r} died (exit code {proc.exitcode}) "
                           f"before {cmd!r}")
        for r, conn in enumerate(self._conns):
            try:
                conn.send((cmd, *args))
            except OSError:             # its end of the pipe is closed
                self._procs[r].join(1.0)
                self._fail(f"rank {r} died (exit code "
                           f"{self._procs[r].exitcode}) before {cmd!r}")
        return self._gather(cmd)

    def _gather(self, cmd: str) -> list:
        """Every rank's reply to ``cmd``, waiting at most ``timeout_s``."""
        deadline = time.monotonic() + self.timeout_s
        replies: list = [None] * self.n
        pending = set(range(self.n))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"rank(s) {sorted(pending)} past the deadline of "
                           f"{self.timeout_s:g} s on {cmd!r}")
            by_conn = {self._conns[r]: r for r in pending}
            by_sentinel = {self._procs[r].sentinel: r for r in pending}
            ready = mpc.wait(list(by_conn) + list(by_sentinel), timeout=left)
            # a rank's last message may land with its exit, so a rank counts
            # as dead only with nothing left to read; the dead come first,
            # since their peers' errors are only the echo of their death
            ranks = sorted({by_conn[o] for o in ready if o in by_conn})
            dead = sorted({by_sentinel[o] for o in ready if o in by_sentinel}
                          - set(ranks))
            for r in dead + ranks:
                conn = self._conns[r]
                try:
                    if r in dead and not conn.poll():
                        raise EOFError
                    status, value = conn.recv()
                except (EOFError, OSError):
                    self._procs[r].join(1.0)
                    self._fail(f"rank {r} died (exit code "
                               f"{self._procs[r].exitcode}) during {cmd!r}")
                if status == "error":
                    self._fail(f"rank {r} raised during {cmd!r}:\n{value}")
                replies[r] = value
                pending.discard(r)
        return replies
