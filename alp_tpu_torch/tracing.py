"""Spans and counters of the port's host work, on the profiler's clock.

A span names a stretch of host work, or of the host waiting on the
device, by the layer it belongs to:

* ``alp.engine.<query>`` around each public query, and inside them
  ``alp.engine.sum.join``, ``alp.engine.rank.pass`` (with
  ``alp.engine.rank.probes`` and ``alp.engine.rank.narrow``) and
  ``alp.engine.groups.finish``;
* ``alp.fetch.<site>`` around every place the host waits on the device:
  a copy to the host (``.cpu()``, ``.tolist()``, ``int(tensor)``), an
  implicit wait (``torch.nonzero``, a boolean mask, a Python scalar
  written through a tensor index) and an upload from pageable memory
  (PyTorch synchronises the stream after it);
* ``alp.plan.build`` (``.stack``, ``.upload``), ``alp.plan.run``,
  ``alp.plan.decode_vectors``, ``alp.plan.decode_rd``, ``alp.plan.patch``;
* ``alp.kernel.<wrapper>`` around a CUDA wrapper's host work, from its
  checks to the return of the launch (plain CPU runs have none);
* ``alp.compress`` around ``compress_device`` and ``alp.compress.<stage>``
  around its host stages; ``alp.build`` around a build that compiles;
* ``alp.gc`` around each collection of Python's garbage collector.

While a ``torch.profiler`` records, every span is also a
``record_function`` of the same name, so it lies in the profiler's trace
on the host clock of the launches that the trace ties to each device
operation.  With no profiler recording a span never calls into the
profiler: it reads one flag, the clock twice and updates one entry of
the running totals, which every span keeps either way (``totals()``: the
calls, seconds and seconds of ``alp.fetch.*`` descendants of each name;
and the counters).

Counters: ``count(name, n)``.  The kernel modules' ``LAUNCHES``
(``alp.launch.<kernel>``), ``engine.LAST_RANK_PASSES``
(``alp.engine.rank.last_passes``) and ``device_compress.TO_HOST``
(``alp.compress.to_host.bytes``) are views of counters here
(:class:`Counters`); ``alp.builds`` counts builds that compiled.
"""

from __future__ import annotations

import collections.abc
import functools
import gc
import threading
import time

import torch
import torch.autograd.profiler as _profiler

FETCH = "alp.fetch."
_clock = time.perf_counter_ns
_SPANS: dict = {}      # name -> [calls, ns, ns of alp.fetch.* descendants]
_COUNTS: dict = {}     # name -> int


class _Local(threading.local):
    def __init__(self):
        # the thread's open spans: each the ns of its alp.fetch.* spans
        self.stack = []


_local = _Local()


def _add(name: str, ns: int, fetch_ns: int) -> None:
    t = _SPANS.get(name)
    if t is None:
        t = _SPANS[name] = [0, 0, 0]
    t[0] += 1
    t[1] += ns
    t[2] += fetch_ns


class span:
    """``with span(name):`` a stretch of host work, added to ``totals()``
    and, while a profiler records, a ``record_function`` of ``name``."""
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        _local.stack.append(0)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        ns = _clock() - self._t0
        stack = _local.stack
        fetch_ns = stack.pop()
        if stack:
            stack[-1] += ns if self.name.startswith(FETCH) else fetch_ns
        _add(self.name, ns, fetch_ns)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def kernel(fn):
    """Decorator of a kernel wrapper: a call whose first argument lies on
    a card runs inside ``span("alp.kernel.<fn's name>")``; a plain CPU run
    has no span."""
    name = "alp.kernel." + fn.__name__

    @functools.wraps(fn)
    def call(first, *args, **kwargs):
        if not first.is_cuda:
            return fn(first, *args, **kwargs)
        with span(name):
            return fn(first, *args, **kwargs)
    return call


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: {"calls", "seconds", "fetch_seconds"}}, "counts":
    {name: n}} since the import or the last ``reset()``."""
    return {"spans": {name: {"calls": c, "seconds": ns * 1e-9,
                             "fetch_seconds": f * 1e-9}
                      for name, (c, ns, f) in _SPANS.items()},
            "counts": dict(_COUNTS)}


def reset(*names: str) -> None:
    """Forget the spans and counters ``names``, or with none every one."""
    if not names:
        _SPANS.clear()
        _COUNTS.clear()
    for name in names:
        _SPANS.pop(name, None)
        _COUNTS.pop(name, None)


class Counters(collections.abc.MutableMapping):
    """A dict of some counters: key ``k`` is the counter ``prefix + k``;
    the keys are fixed, each reads 0 until counted."""

    def __init__(self, prefix: str, keys):
        self._prefix = prefix
        self._keys = tuple(keys)

    def _name(self, key) -> str:
        if key not in self._keys:
            raise KeyError(key)
        return self._prefix + key

    def __getitem__(self, key) -> int:
        return _COUNTS.get(self._name(key), 0)

    def __setitem__(self, key, value) -> None:
        _COUNTS[self._name(key)] = int(value)

    def __delitem__(self, key):
        raise TypeError("the keys of a Counters are fixed")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))

    def reset(self) -> None:
        """Every counter of the view back to 0."""
        for key in self._keys:
            _COUNTS[self._prefix + key] = 0


_gc_open: list = [0, None]      # the collection's start ns, its record


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: each collection a span ``alp.gc``."""
    if phase == "start":
        _gc_open[1] = None
        if _profiler._is_profiler_enabled:
            _gc_open[1] = torch.profiler.record_function("alp.gc")
            _gc_open[1].__enter__()
        _gc_open[0] = _clock()
        return
    _add("alp.gc", _clock() - _gc_open[0], 0)
    if _gc_open[1] is not None:
        _gc_open[1].__exit__(None, None, None)
        _gc_open[1] = None


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)
