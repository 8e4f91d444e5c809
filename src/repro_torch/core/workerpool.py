"""Supervised process pool: crashed workers restart, repeat offenders
quarantine.

``multiprocessing.Pool`` turns one crashed worker (segfault, OOM kill,
``os._exit``) into a hung or failed *whole search*.  This pool supervises
instead:

* each worker is a dedicated process with its own duplex pipe; the parent
  always knows **which task** a worker was running, so a crash is
  attributed exactly;
* a crashed worker is restarted and its task re-queued;
* a task that has killed ``quarantine_after`` workers (default 2 — one
  crash could be the worker's bad luck, two on the same task is the task)
  is **quarantined**: its slot in the result list becomes a
  :class:`Quarantined` marker instead of taking the pool down a third
  time.  The caller decides what "serve baseline" means for its domain
  (the autotuning search drops the variant; the daemon degrades the
  response).

Determinism: results are ordered by submission index regardless of worker
scheduling, task functions are pure, and the parent's fault-injection plan
(:mod:`repro_torch.testing.faults`) is forwarded to every worker — injected
crash schedules are keyed by ``(task index, attempt)``, so a chaos run
replays identically.

Exceptions *raised by a task* (as opposed to a worker death) propagate to
the caller after the pool shuts down, matching ``Pool.map`` semantics.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from multiprocessing.connection import wait as _conn_wait
from typing import Callable, List, Optional, Sequence

from repro_torch import obs
from repro_torch.testing import faults as _faults

#: how many workers one task may kill before it is quarantined
QUARANTINE_AFTER = 2


class Quarantined:
    """Result placeholder for a task that repeatedly killed its worker."""

    __slots__ = ("index", "crashes")

    def __init__(self, index: int, crashes: int):
        self.index = index
        self.crashes = crashes

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Quarantined(index={self.index}, crashes={self.crashes})"


class WorkerCrashError(RuntimeError):
    """Raised only when supervision itself cannot make progress (e.g. a
    worker dies faster than it can accept any task, repeatedly)."""


def _worker_main(conn, fn: Callable, seed: int, plan) -> None:
    """Worker loop: receive ``(index, attempt, payload)``, run, reply.

    The parent's fault plan is installed first, so injected ``worker.crash``
    faults fire *here* — a hard ``os._exit`` that never unwinds, exactly
    like a segfault from the parent's point of view.
    """
    random.seed(seed)
    if plan is not None:
        _faults.install(plan)
    while True:
        msg = conn.recv()
        if msg is None:
            conn.close()
            return
        index, attempt, payload = msg
        inj = _faults.active()
        if inj is not None and inj.fire("worker.crash", str(index), attempt):
            os._exit(13)
        try:
            result = fn(payload)
        except BaseException as exc:  # ship the exception to the parent
            try:
                conn.send((index, False, exc))
            except Exception:
                conn.send((index, False, RuntimeError(repr(exc))))
            continue
        conn.send((index, True, result))


class _Worker:
    __slots__ = ("proc", "conn", "current", "attempt")

    def __init__(self, ctx, fn, seed, plan):
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=_worker_main, args=(child_conn, fn, seed, plan), daemon=True
        )
        self.proc.start()
        child_conn.close()
        self.conn = parent_conn
        self.current: Optional[int] = None  # task index in flight
        self.attempt = 0


def supervised_map(
    fn: Callable,
    payloads: Sequence,
    workers: int,
    seed: int = 0,
    quarantine_after: int = QUARANTINE_AFTER,
) -> List[object]:
    """Map ``fn`` over ``payloads`` on a supervised process pool.

    Returns results in submission order; slots whose task was quarantined
    hold a :class:`Quarantined` instance.  ``workers <= 1`` (or a single
    payload) runs in-process — byte-identical results, no supervision
    needed (and injected worker crashes never fire in-process: they would
    take down the caller, which is exactly what the pool exists to
    prevent).
    """
    n = len(payloads)
    if workers <= 1 or n <= 1:
        return [fn(p) for p in payloads]
    try:
        ctx = multiprocessing.get_context("fork")
    except ValueError:  # pragma: no cover - non-POSIX fallback
        ctx = multiprocessing.get_context("spawn")

    plan = None
    inj = _faults.active()
    if inj is not None:
        plan = inj.plan

    n_workers = min(workers, n)
    results: List[object] = [None] * n
    done = [False] * n
    crashes = [0] * n
    pending: List[int] = list(range(n))  # FIFO of task indices
    task_error: Optional[BaseException] = None

    pool: List[_Worker] = [
        _Worker(ctx, fn, seed, plan) for _ in range(n_workers)
    ]

    def dispatch() -> None:
        for i, w in enumerate(pool):
            if w.current is None and pending and task_error is None:
                idx = pending.pop(0)
                try:
                    w.conn.send((idx, crashes[idx], payloads[idx]))
                except (OSError, BrokenPipeError):
                    # worker died while idle: replace it and re-queue
                    pending.insert(0, idx)
                    w.proc.join()
                    pool[i] = _Worker(ctx, fn, seed, plan)
                    continue
                w.current = idx
                w.attempt = crashes[idx]

    def handle_crash(w: _Worker) -> Optional[_Worker]:
        idx = w.current
        try:
            w.conn.close()
        except OSError:
            pass
        w.proc.join()
        if idx is not None:
            crashes[idx] += 1
            if obs.enabled():
                obs.metrics().counter("workerpool.crashes").inc()
            if crashes[idx] >= quarantine_after:
                results[idx] = Quarantined(idx, crashes[idx])
                done[idx] = True
                if obs.enabled():
                    obs.metrics().counter("workerpool.quarantined").inc()
            else:
                pending.insert(0, idx)  # retry first: keeps latency bounded
        # restart unless there is nothing left for a fresh worker to do
        if pending or any(
            ww.current is not None for ww in pool if ww is not w
        ):
            if obs.enabled():
                obs.metrics().counter("workerpool.restarts").inc()
            return _Worker(ctx, fn, seed, plan)
        return None

    try:
        while not all(done) and task_error is None:
            dispatch()
            busy = [w for w in pool if w.current is not None]
            if not busy:
                if pending:
                    # workers died without accepting work and were not
                    # replaced — cannot happen unless spawning itself fails
                    raise WorkerCrashError(
                        "no live workers left with tasks still pending"
                    )
                break
            readable = _conn_wait(
                [w.conn for w in busy] + [w.proc.sentinel for w in busy]
            )
            replaced: List[tuple] = []
            for w in busy:
                if w.conn in readable:
                    try:
                        index, ok, value = w.conn.recv()
                    except (EOFError, OSError):
                        # died mid-send: treat as a crash on this task
                        nw = handle_crash(w)
                        if nw is not None:
                            replaced.append((w, nw))
                        continue
                    if ok:
                        results[index] = value
                        done[index] = True
                    else:
                        task_error = value
                    w.current = None
                elif w.proc.sentinel in readable and not w.conn.poll():
                    nw = handle_crash(w)
                    if nw is not None:
                        replaced.append((w, nw))
            for old, new in replaced:
                pool[pool.index(old)] = new
    finally:
        for w in pool:
            try:
                if w.proc.is_alive() and w.current is None:
                    w.conn.send(None)
            except (OSError, BrokenPipeError):
                pass
        for w in pool:
            w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2.0)
            try:
                w.conn.close()
            except OSError:
                pass

    if task_error is not None:
        raise task_error
    return results
