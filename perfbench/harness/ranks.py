"""A cell on several cards: one process a rank, each on its own card,
joined by ``torch.distributed`` and held in lockstep.

The process that the benchmark's command starts is rank 0; it keeps the
clock.  It spawns ranks 1 .. W - 1 as the same script with the same
arguments and the hidden ``--rank``, ``--world``, ``--rendezvous`` and
``--deadline-at`` (``add_arguments``).  Every rank sets its card
(``torch.cuda.set_device(rank)``), joins the rendezvous (a file in a new
temporary directory, removed at the end), starts the process group that
the port's mesh needs (NCCL on cards, gloo on the CPU), builds the mesh
(``alp_tpu_torch.parallel.make_mesh``) and starts a gloo group of the
harness's own, so that the harness's agreements never touch a card.

One deadline, printed, covers set-up, the window and the check.  When it
passes, or when any rank exits nonzero, rank 0 kills every rank (each
spawned rank leads a process group of its own) and exits nonzero with no
result line; a spawned rank whose rank 0 is gone ends itself.  Rank 0
copies the output of every other rank to its standard error, each line
prefixed ``rank <r>: ``, and prefixes its own.

Rank r takes rowgroups [R r // W, R (r + 1) // W) of the column's R
rowgroups (the formula of ``alp_tpu_torch.parallel.share``): a run of
whole rowgroups, rows [lo, hi).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

DEADLINE_S = 340.0        # from the start of rank 0's process
POLL_S = 0.1
BACKEND = {"cuda": "nccl", "cpu": "gloo"}
STEP_SPAN = "bench.ranks.step"


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The hidden arguments of a spawned rank (``--rank``, ``--world``,
    ``--rendezvous``, ``--deadline-at``: seconds since the epoch), and
    two that the tests give: ``--device cpu`` (gloo, no card) and
    ``--deadline`` (seconds from the start, ``DEADLINE_S``)."""
    hide = argparse.SUPPRESS
    p.add_argument("--rank", type=int, default=None, help=hide)
    p.add_argument("--world", type=int, default=None, help=hide)
    p.add_argument("--rendezvous", default=None, help=hide)
    p.add_argument("--deadline-at", type=float, default=None, help=hide)
    p.add_argument("--deadline", type=float, default=DEADLINE_S, help=hide)
    p.add_argument("--device", choices=tuple(BACKEND), default="cuda",
                   help=hide)


def rows_of(n: int, world: int, rank: int, rowgroup_rows: int) -> tuple:
    """(lo, hi): the rows of rank ``rank``'s run of whole rowgroups."""
    groups = -(-n // rowgroup_rows)
    if groups < world:
        raise ValueError(f"{n} rows make {groups} rowgroups, fewer than "
                         f"the {world} ranks")
    g0, g1 = groups * rank // world, groups * (rank + 1) // world
    return min(n, g0 * rowgroup_rows), min(n, g1 * rowgroup_rows)


@dataclasses.dataclass
class Ranks:
    """What an op of a multi-rank cell receives as ``ranks``, and the
    harness's own gloo group (``group``), which ops leave alone."""
    mesh: object              # the port's 1-D mesh over every rank
    rank: int
    world: int
    rows: tuple               # (lo, hi): this rank's rows
    n_total: int              # the whole column's rows
    config: dict
    device: object            # this rank's torch.device
    group: object             # the harness's gloo group
    steps: int = 0
    step_ns: int = 0

    def decide(self, go: bool):
        """Start the agreement on whether another request follows this
        one: a broadcast of rank 0's ``go`` on the gloo group, run beside
        the request by gloo's own threads.  Returns the function that
        waits for it and gives the decision."""
        t0 = time.perf_counter_ns()
        flag = torch.tensor([int(go)], dtype=torch.int64)
        work = dist.broadcast(flag, src=0, group=self.group, async_op=True)
        self.steps += 1
        self.step_ns += time.perf_counter_ns() - t0

        def agreed() -> bool:
            t1 = time.perf_counter_ns()
            work.wait()
            go = bool(flag.item())
            self.step_ns += time.perf_counter_ns() - t1
            return go

        return agreed

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0 (None elsewhere),
        over gloo."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def all_gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def run(args, script: str, argv: list, world: int, config: dict, body,
        t_start: float):
    """Run ``body(ranks)`` on every rank of a ``world``-rank cell.  Rank 0
    (``args.rank`` None) spawns the others, returns its ``body``'s value
    once every rank has exited 0, and raises if one did not; it exits
    nonzero at once when the deadline passes or a rank fails.  A spawned
    rank returns None."""
    if args.rank is None:
        deadline_at = time.time() - (time.perf_counter() - t_start) \
            + args.deadline
        with _Launch(script, argv, world, deadline_at) as launch:
            value = _rank(0, world, launch.rendezvous, deadline_at,
                          args.device, config, body)
            launch.wait()
        return value
    if args.world != world:
        raise ValueError(f"rank {args.rank} of {args.world}, the cell has "
                         f"{world}")
    _guard(os.getppid(), args.deadline_at)
    _rank(args.rank, world, args.rendezvous, args.deadline_at, args.device,
          config, body)
    return None


def _rank(rank: int, world: int, rendezvous: str, deadline_at: float,
          device_type: str, config: dict, body):
    from alp_tpu_torch import parallel

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    timeout = datetime.timedelta(seconds=max(1.0, deadline_at - time.time()))
    dist.init_process_group(BACKEND[device_type],
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=timeout)
    try:
        group = dist.new_group(backend="gloo", timeout=timeout)
        mesh = parallel.make_mesh(world, device_type)
        n = int(config["rows"])
        per_group = (int(config.get("vector_size", 1024))
                     * int(config.get("rowgroup_vectors", 100)))
        ranks = Ranks(mesh, rank, world, rows_of(n, world, rank, per_group),
                      n, config, device, group)
        return body(ranks)
    finally:
        dist.destroy_process_group()


def _guard(parent: int, deadline_at: float) -> None:
    """End this spawned rank when its rank 0 is gone, or a little after
    the deadline (rank 0 kills it at the deadline)."""
    def watch():
        while True:
            time.sleep(POLL_S)
            if os.getppid() != parent or time.time() > deadline_at + 10:
                os._exit(9)

    threading.Thread(target=watch, daemon=True).start()


class _Prefixed:
    """A text stream that prefixes each line written to ``stream``."""

    def __init__(self, stream, prefix: str, lock: threading.Lock):
        self.stream, self.prefix, self.lock = stream, prefix, lock
        self.at_start = True

    def write(self, text: str) -> int:
        with self.lock:
            for part in text.splitlines(keepends=True):
                if self.at_start:
                    self.stream.write(self.prefix)
                self.stream.write(part)
                self.at_start = part.endswith("\n")
        return len(text)

    def flush(self) -> None:
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


class _Launch:
    """Rank 0's side: the rendezvous directory, the spawned ranks, the
    copies of their output and the watchdog."""

    def __init__(self, script: str, argv: list, world: int,
                 deadline_at: float):
        self.script, self.argv, self.world = script, list(argv), world
        self.deadline_at = deadline_at
        self.lock = threading.Lock()        # output lines
        self.state = threading.Lock()       # the watchdog against wait()
        self.done = False
        self.procs, self.copies = [], []

    def __enter__(self):
        self.err = sys.stderr
        self.dir = tempfile.mkdtemp(prefix="perfbench-ranks-")
        self.rendezvous = os.path.join(self.dir, "rendezvous")
        left = self.deadline_at - time.time()
        print(f"perfbench: {self.world} ranks, deadline in {left:.1f} s "
              f"(set-up, window and check)", file=self.err, flush=True)
        try:
            for r in range(1, self.world):
                self._spawn(r)
        except BaseException:
            self._end()
            raise
        sys.stderr = _Prefixed(self.err, "rank 0: ", self.lock)
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def _spawn(self, r: int) -> None:
        cmd = [sys.executable, self.script, *self.argv, "--rank", str(r),
               "--world", str(self.world), "--rendezvous", self.rendezvous,
               "--deadline-at", repr(self.deadline_at)]
        p = subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                             env={**os.environ, "PYTHONUNBUFFERED": "1"},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             errors="replace", start_new_session=True)
        self.procs.append(p)
        print(f"perfbench: rank {r} pid {p.pid}", file=self.err, flush=True)
        t = threading.Thread(target=self._copy, args=(p.stdout, r),
                             daemon=True)
        t.start()
        self.copies.append(t)

    def _copy(self, stream, r: int) -> None:
        for line in stream:
            with self.lock:
                self.err.write(f"rank {r}: {line}")
                self.err.flush()

    def _fault(self) -> str | None:
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
               if p.poll() not in (None, 0)]
        if bad:
            return ", ".join(f"rank {r} exited {c}" for r, c in bad)
        if time.time() > self.deadline_at:
            return "the deadline passed"
        return None

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            with self.state:
                if self.done:
                    return
                why = self._fault()
                if why is None:
                    continue
                self._kill()
                sys.stderr = self.err
                left = self.deadline_at - time.time()
                print(f"perfbench: {why}; every rank killed, no result "
                      f"({left:.1f} s before the deadline)", file=self.err,
                      flush=True)
                shutil.rmtree(self.dir, ignore_errors=True)
                os._exit(5)

    def wait(self) -> None:
        """Rank 0's part has ended: wait for every other rank to exit 0."""
        while any(p.poll() is None for p in self.procs):
            time.sleep(POLL_S)
        with self.state:
            why = self._fault()
            if why is not None:
                raise RuntimeError(why)
            self.done = True

    def _kill(self) -> None:
        for p in self.procs:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(p.pid, signal.SIGKILL)
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=30)

    def _end(self) -> None:
        with self.state:
            self.done = True
            if any(p.poll() is None for p in self.procs):
                self._kill()
        for t in self.copies:
            t.join(timeout=10)
        sys.stderr = self.err
        shutil.rmtree(self.dir, ignore_errors=True)

    def __exit__(self, *exc):
        self._end()
        return False
