"""Start the ranks of a distributed run: the port's counterpart of
``mpirun``.

``run_ranks(fn, world, backend)`` spawns ``world`` processes, one rank
each.  Every rank joins one process group (``torch.distributed``) through
a rendezvous file in a fresh temporary directory, so no port is fixed;
with ``nccl`` rank r takes card r (``torch.cuda.set_device(r)``), with
``gloo`` every rank runs on the host.  The rank then calls
``fn(*args)`` (``fn(rank_args[r], *args)`` when ``rank_args`` is given)
with DTensor's implicit replication on, so a plain tensor beside a
sharded vector counts as replicated (the solvers' ``(k,)`` scalars and
masks), and hands back what ``fn`` returns.

A rank that raises, or exits, fails the whole run: the parent kills the
other ranks and raises a ``RuntimeError`` holding every failed rank's
traceback (the rank that raised first, and the peers its exit broke).  A run that outlasts ``timeout``
seconds is killed and raises ``TimeoutError``: a rank stuck in a
collective is an error, never a stalled caller.  Nothing falls back: a
``nccl`` run needs ``world`` cards and raises without them.

``fn`` must be importable by name (a module-level function; the ranks
are spawned, so a script that starts them guards its own work with
``if __name__ == "__main__"``), and what it takes and returns must
pickle.  A function of a file loaded by path (an example) runs through
``call_in_file``.  ``rank_args`` travel through files in the
temporary directory, one a rank, so a parent that planned a large system
once ships each rank only its slice.

``RankGroup(world, backend)`` keeps ranks up across calls instead: the
calling process joins the group as rank 0 (card 0 under ``nccl``) and
spawns ``world - 1`` followers once; ``group.call(fn, *args, lead=...)``
runs ``fn`` on every rank in lock-step and returns rank 0's result.  A
time-stepper that solves once a step, or a benchmark's closed loop, drives
a distributed solve through it without a launch a call.
"""

from __future__ import annotations

import atexit
import importlib.util
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta

from ..log.profiler_hook import count, span

BACKENDS = ("nccl", "gloo")
# the followers wait for their next command on the control group as long
# as their leader lives (its death ends them, ``_die_with``)
CONTROL_TIMEOUT = timedelta(days=7)
LEADER_GRACE = 2.0     # s a call waits for the followers after rank 0 raised
CLOSE_GRACE = 30.0     # s ``close`` waits for a follower to exit
JOIN_TIMEOUT = 600.0   # s the group's ranks may take to start and join


def _join(rank, world, backend, tmp, timeout):
    """Join the group of ``world`` ranks that meet at ``tmp`` as ``rank``
    (under ``nccl`` on card ``rank``)."""
    import torch
    import torch.distributed as dist

    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout), **kw)


def _rank_main(rank, fn, world, backend, args, tmp, threads, timeout):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    if threads:
        torch.set_num_threads(int(threads))
    _join(rank, world, backend, tmp, timeout)
    try:
        path = os.path.join(tmp, f"in{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                args = (pickle.load(f),) + tuple(args)
        with implicit_replication():
            out = fn(*args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    except BaseException:
        # written before this rank exits, so before its exit breaks a
        # peer's collective: the parent reports the cause with the rest
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _rank_errors(tmp, world) -> str:
    """The tracebacks the failed ranks wrote, rank by rank."""
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"err{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"rank {r} of {world} failed:\n{f.read()}")
    return "\n".join(out)


def _check_ranks(world: int, backend: str, rank_args) -> int:
    """``world`` as an int, once the backend, the cards a ``nccl`` group
    needs and ``rank_args``' length are checked."""
    import torch

    world = int(world)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(f"nccl ranks need one card each: {world} "
                               f"ranks asked, {cards} cards present")
    if rank_args is not None and len(rank_args) != world:
        raise ValueError(f"rank_args has {len(rank_args)} entries for "
                         f"{world} ranks")
    return world


def run_ranks(fn, world: int, backend: str, args=(), rank_args=None,
              timeout: float = 600.0, threads: int | None = None):
    """Run ``fn`` on ``world`` ranks; the list of what each rank returned,
    rank 0 first.  ``backend``: ``"nccl"`` (rank r on card r) or
    ``"gloo"`` (the host).  ``rank_args``: one object a rank, passed as
    ``fn``'s first argument.  ``threads``: torch's intra-op threads a rank
    (default: torch's own)."""
    import torch.multiprocessing as mp

    world = _check_ranks(world, backend, rank_args)
    tmp = tempfile.mkdtemp(prefix="gtt_ranks_")
    try:
        for r, payload in enumerate(rank_args or ()):
            with open(os.path.join(tmp, f"in{r}.pkl"), "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, tuple(args), tmp, threads,
                              timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # join() raises the first rank's failure, after killing the rest
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} {backend} ranks did not end "
                                       f"within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_rank_errors(tmp, world) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _die_with(leader: int):
    """End this process when its leader ends, however it ends: the kernel
    sends SIGKILL when the thread that spawned it exits
    (``PR_SET_PDEATHSIG``); a leader already gone ends it now."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:     # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != leader:
        os._exit(1)


def _follower_main(rank, world, backend, tmp, timeout, leader, status):
    """A follower of a ``RankGroup``: join, then run each command that
    rank 0 broadcasts on the control group until the empty one, putting
    ``(rank, call, traceback or None)`` on ``status`` after each.  A
    command that cannot be received ends the follower."""
    _die_with(leader)
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    _join(rank, world, backend, tmp, timeout)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    try:
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=control)
            if msg[0] is None:
                break
            cid, fn, args, shipped = msg[0]
            try:
                if shipped:
                    mine = [None]
                    dist.recv_object_list(mine, src=0, group=control)
                    args = (mine[0],) + tuple(args)
                with implicit_replication():
                    fn(*args, lead=None)
            except Exception:
                status.put((rank, cid, traceback.format_exc()))
            else:
                status.put((rank, cid, None))
    finally:
        dist.destroy_process_group()


class RankGroup:
    """``world`` ranks that stay up across calls, led by the process that
    makes the group: it joins as rank 0 (card 0 under ``nccl``, the host
    under ``gloo``) and spawns ``world - 1`` followers (rank r on card r),
    which wait for commands until :meth:`close`.

    ``call(fn, *args, lead=None, rank_args=None)`` runs ``fn(*args,
    lead=...)`` on every rank with implicit replication on, as
    ``run_ranks`` does, and returns rank 0's result.  Only rank 0 gets
    ``lead``, which may hold its device tensors (a block of right-hand
    sides on card 0); the followers get None, and ``fn`` moves data
    between the ranks with collectives.  ``rank_args``: one object a rank,
    passed as ``fn``'s first argument (rank r's is pickled to it alone:
    numpy arrays that a leader planned once).  The command itself (``fn``
    by its importable name and ``args``) reaches the followers as a small
    pickled broadcast on a gloo control group; no tensor is pickled.

    The contract is ``run_ranks``': a follower that raises fails the call
    with its traceback; a call that outlasts ``timeout`` seconds raises
    ``TimeoutError`` (a follower stuck in a collective, or rank 0 stuck in
    one with a follower); a follower that exits fails the call.  A failed
    call kills the followers and closes the group.  :meth:`close` (also
    at exit) ends the followers and destroys the process group.  A
    follower exits within moments of its leader's death, however the
    leader died, so make the group on a thread that outlives it (the main
    thread).  A follower takes torch's threads from the environment it
    inherits (``OMP_NUM_THREADS``).  A process leads one group at a time
    (it has one default process group).
    """

    def __init__(self, world: int, backend: str, timeout: float = 600.0):
        import torch.distributed as dist
        import torch.multiprocessing as mp

        self.world = _check_ranks(world, backend, None)
        if dist.is_initialized():
            raise RuntimeError("this process is already a rank of a "
                               "process group")
        self.backend, self.timeout = backend, float(timeout)
        self.closed = False
        self._calls = 0
        self._tmp = tempfile.mkdtemp(prefix="gtt_group_")
        ctx = mp.get_context("spawn")
        self._status = ctx.Queue()
        self._followers = []
        # the group's own timeout covers the followers' start; a call's
        # deadline is the watch's (``_Watch``)
        join = max(self.timeout, JOIN_TIMEOUT)
        try:
            for r in range(1, self.world):
                p = ctx.Process(target=_follower_main, daemon=True, args=(
                    r, self.world, backend, self._tmp, join, os.getpid(),
                    self._status))
                p.start()
                self._followers.append(p)
            _join(0, self.world, backend, self._tmp, join)
            self._control = dist.new_group(backend="gloo",
                                           timeout=CONTROL_TIMEOUT)
        except BaseException:
            self._break()
            raise
        atexit.register(self.close)

    @property
    def pids(self) -> list:
        """The followers' process ids, rank 1 first."""
        return [p.pid for p in self._followers]

    def call(self, fn, *args, lead=None, rank_args=None):
        """``fn(*args, lead=...)`` on every rank (``fn(rank_args[r],
        *args, lead=...)`` with ``rank_args``); rank 0's result."""
        import torch.distributed as dist
        from torch.distributed.tensor.experimental import \
            implicit_replication

        if self.closed:
            raise RuntimeError("the rank group is closed")
        if rank_args is not None and len(rank_args) != self.world:
            raise ValueError(f"rank_args has {len(rank_args)} entries for "
                             f"{self.world} ranks")
        self._calls += 1
        cid = self._calls
        watch = _Watch(self, cid)
        error = None
        try:
            with span("dist.call"):
                count("dist_calls")
                dist.broadcast_object_list(
                    [(cid, fn, args, rank_args is not None)], src=0,
                    group=self._control)
            if rank_args is not None:
                for r in range(1, self.world):
                    dist.send_object_list([rank_args[r]], dst=r,
                                          group=self._control)
                args = (rank_args[0],) + args
            with implicit_replication():
                out = fn(*args, lead=lead)
        except BaseException as e:
            error = e
        self._status.put((0, cid, None))
        # a rank 0 that raised on its own may leave the followers waiting
        # in a collective: give them a moment to report, then end them
        watch.join(None if error is None else LEADER_GRACE)
        watch.stop = True
        watch.join()
        if watch.failure is not None:
            self._break()
            raise watch.failure from error
        if error is not None:
            self._break()
            raise error
        return out

    def _abort(self):
        """Kill the followers; under ``nccl`` also abort this process's
        communicators, so that a kernel waiting for a follower ends."""
        import torch.distributed as dist

        for p in self._followers:
            if p.is_alive():
                p.kill()
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if self.backend == "nccl" and abort is not None and \
                dist.is_initialized():
            abort()

    def _break(self):
        """After a failed call: end the followers, drop this process's
        group without a word to them, and close."""
        import torch.distributed as dist

        self._abort()
        if dist.is_initialized():
            dist.destroy_process_group()
        self._finish()

    def close(self):
        """End the followers and destroy the process group; a closed
        group's ``close`` does nothing."""
        if self.closed:
            return
        import torch.distributed as dist

        try:
            dist.broadcast_object_list([None], src=0, group=self._control)
        except RuntimeError:        # a follower is gone already
            self._break()
            return
        for p in self._followers:
            p.join(timeout=CLOSE_GRACE)
            if p.is_alive():
                p.kill()
        dist.destroy_process_group()
        self._finish()

    def _finish(self):
        from .mesh import _DEVICE_MESHES

        for p in self._followers:
            p.join()
        _DEVICE_MESHES.clear()      # their groups are gone
        shutil.rmtree(self._tmp, ignore_errors=True)
        self.closed = True
        atexit.unregister(self.close)


class _Watch(threading.Thread):
    """Rank 0's watch over one call: collects every rank's end of it from
    the status queue (rank 0 puts its own when ``fn`` returns).  A
    follower's traceback, a follower's exit or the deadline sets
    ``failure`` and kills the followers at once, so that a collective rank
    0 waits in fails instead of waiting for them."""

    def __init__(self, group: RankGroup, cid: int):
        super().__init__(daemon=True)
        self.group, self.cid = group, cid
        self.deadline = time.monotonic() + group.timeout
        self.failure = None
        self.stop = False
        self.start()

    def run(self):
        g = self.group
        pending = set(range(g.world))
        while pending and self.failure is None and not self.stop:
            try:
                rank, cid, tb = g._status.get(timeout=0.05)
            except queue.Empty:
                dead = [r for r in sorted(pending - {0})
                        if not g._followers[r - 1].is_alive()]
                if dead:
                    self.failure = RuntimeError(
                        f"rank {dead[0]} of {g.world} exited (code "
                        f"{g._followers[dead[0] - 1].exitcode})")
                elif time.monotonic() > self.deadline:
                    self.failure = TimeoutError(
                        f"{g.world} {g.backend} ranks did not end a call "
                        f"within {g.timeout} s")
                continue
            if tb is not None:
                self.failure = RuntimeError(f"rank {rank} of {g.world} "
                                            f"failed:\n{tb}")
            elif cid == self.cid:
                pending.discard(rank)
        if self.failure is not None:
            g._abort()


def call_in_file(path, name, *args):
    """``name(*args)`` of the Python file at ``path``, loaded as a fresh
    module: the rank body of a script whose functions cannot be imported
    by name (``run_ranks(call_in_file, ..., args=(__file__, "run",
    ...))``)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"_ranked_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)(*args)
