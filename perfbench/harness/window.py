"""The measured window: a closed loop of one client, and its arithmetic.

The client issues a request, waits for its answer, and issues the next,
until ``seconds`` have passed and at least ``min_requests`` were issued;
the window ends when the last request answers.  Its latency runs on the
host clock from the call to the answer (for a scan, the device tensor
after ``torch.cuda.synchronize()``).  A request that raises has failed:
it counts as missing every latency limit.  On several ranks the loop runs
in lockstep (``lockstep_loop``): rank 0's clock decides when it ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time


@dataclasses.dataclass
class Record:
    index: int
    template: str
    op: str
    column: str
    params: dict
    t0_ns: int
    t1_ns: int
    ok: bool
    error: str = ""
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


@dataclasses.dataclass
class Window:
    records: list
    t0_ns: int
    t1_ns: int
    answers: dict             # record index -> kept answer

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


def no_span(name):
    return contextlib.nullcontext()


def closed_loop(stream, call, seconds: float, min_requests: int = 1,
                keep=None, span=no_span) -> Window:
    """Run requests of ``stream`` back to back: ``call(request, span)``
    returns (answer, counters).  ``keep(request)`` says whether to hold
    the answer for the check."""
    records, answers = [], {}
    t_begin = time.perf_counter_ns()
    deadline = t_begin + int(seconds * 1e9)
    t_end = t_begin
    answer = None
    while t_end < deadline or len(records) < min_requests:
        req = next(stream)
        answer = None           # the last answer is freed before the call
        counters, error = {}, ""
        t0 = time.perf_counter_ns()
        try:
            with span(f"request.{req.template}"):
                answer, counters = call(req, span)
            ok = True
        except Exception as e:  # a failed request is counted, not fatal
            ok, error = False, f"{type(e).__name__}: {e}"
        t_end = time.perf_counter_ns()
        records.append(Record(req.index, req.template, req.op, req.column,
                              req.params, t0, t_end, ok, error, counters))
        if ok and keep is not None and keep(req):
            answers[req.index] = answer
    return Window(records, t_begin, t_end, answers)


def lockstep_loop(stream, call, seconds: float, min_requests: int,
                  keep, span, decide, step_span: str) -> Window:
    """``closed_loop`` on every rank of a cell on several cards, each
    calling the same requests.  Just before each request, rank 0 decides
    whether another will follow it (while its clock is short of
    ``seconds`` or fewer than ``min_requests`` would have been issued);
    ``decide(go)`` starts the agreement, which runs beside the request,
    and returns the function that waits for it once the request has
    answered.  Both lie in spans ``step_span``, outside the request's
    span and its latency."""
    records, answers = [], {}
    t_begin = time.perf_counter_ns()
    deadline = t_begin + int(seconds * 1e9)
    t_end = t_begin
    answer = None
    go = True
    while go:
        req = next(stream)
        answer = None           # the last answer is freed before the call
        counters, error = {}, ""
        with span(step_span):
            agreed = decide(time.perf_counter_ns() < deadline
                            or len(records) + 1 < min_requests)
        t0 = time.perf_counter_ns()
        try:
            with span(f"request.{req.template}"):
                answer, counters = call(req, span)
            ok = True
        except Exception as e:  # a failed request is counted, not fatal
            ok, error = False, f"{type(e).__name__}: {e}"
        t_end = time.perf_counter_ns()
        records.append(Record(req.index, req.template, req.op, req.column,
                              req.params, t0, t_end, ok, error, counters))
        if ok and keep is not None and keep(req):
            answers[req.index] = answer
        with span(step_span):
            go = agreed()
    return Window(records, t_begin, t_end, answers)


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile: the ceil(p / 100 * n)-th least
    value."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100 * len(ordered)))
    return ordered[rank - 1]


def latencies(win: Window) -> list:
    """Every request's latency in seconds; a failed one is +inf."""
    return [r.seconds if r.ok else math.inf for r in win.records]


def rate(win: Window, bytes_of) -> float:
    """Work over the whole window: ``bytes_of(record)`` summed over every
    request that answered, over the window's seconds."""
    done = sum(bytes_of(r) for r in win.records if r.ok)
    return done / win.seconds
