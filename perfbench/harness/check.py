"""What decides ``correct``: the answers of the window against the plain
reference.

After the window, with the program's state freed, each column's values
are generated again from the seed.  Every kept answer is held against the
reference's answer to the same question (one reference a distinct
question), by the numbers its op names (``NUMBERS``: name -> limit).  Two
numbers are the harness's own: ``unanswered``, the requests that raised,
and ``unchecked``, the templates of the window with no answer checked.
Each number is the largest over the answers; each limit is 0.

On several ranks each rank generates its own share again, and for each
distinct question its op's ``reference_share(values, params, cache)``
gives a part that joins exactly (integers and counts); rank 0 gathers the
parts and ``join(parts, params)`` gives the expected answer (``joined``).
A third harness number, ``ranks_disagree``, counts the kept answers that
some rank gave otherwise, by bits, than rank 0 (``digest``).
"""

from __future__ import annotations

import hashlib

import numpy as np

HARNESS_NUMBERS = {"unanswered": 0, "unchecked": 0}
DISAGREE = "ranks_disagree"


def questions(records, answers: dict, op_of) -> dict:
    """column -> {(op, key): params}: the distinct questions of the kept
    answers, in the order of the records."""
    out = {}
    for r in records:
        if r.index in answers:
            k = (r.op, op_of(r.op).key(r.params))
            out.setdefault(r.column, {}).setdefault(k, r.params)
    return out


def check(records, answers: dict, op_of, values_of) -> tuple:
    """``records`` of the window, ``answers`` (record index -> answer),
    ``op_of(name)`` the op modules, ``values_of(column)`` the column's
    generated values.  Returns ({number: (value, limit)}, checked)."""
    def expected_of(column, qs):
        values = values_of(column)
        cache = {}
        return {k: op_of(k[0]).reference(values, params, cache)
                for k, params in qs.items()}

    return judge(records, answers, op_of, expected_of)


def judge(records, answers: dict, op_of, expected_of) -> tuple:
    """``check`` with the references given: ``expected_of(column, qs)``
    maps each question of ``questions`` of the column to its answer."""
    numbers = dict(HARNESS_NUMBERS)
    value = {name: 0 for name in numbers}
    for r in records:
        for name, limit in op_of(r.op).NUMBERS.items():
            if numbers.setdefault(name, limit) != limit:
                raise ValueError(f"number {name!r} has two limits")
            value.setdefault(name, 0)
    value["unanswered"] = sum(not r.ok for r in records)
    templates = {r.template for r in records}
    seen = set()
    checked = 0
    for column, qs in questions(records, answers, op_of).items():
        expected = expected_of(column, qs)
        for r in records:
            if r.column != column or r.index not in answers:
                continue
            op = op_of(r.op)
            got = op.compare(answers[r.index],
                             expected[(r.op, op.key(r.params))])
            for name, v in got.items():
                value[name] = max(value[name], v)
            seen.add(r.template)
            checked += 1
        del expected
    value["unchecked"] = len(templates - seen)
    return {n: (value[n], numbers[n]) for n in numbers}, checked


def joined(ranks, op_of, qs_by_column: dict, values_of) -> dict | None:
    """On every rank: each question's ``reference_share`` of this rank's
    values (``values_of(column)``, its share), gathered on rank 0 and
    joined.  Rank 0 gets {column: {question: answer}}, the others None."""
    out = {}
    for column, qs in qs_by_column.items():
        values = values_of(column)
        cache = {}
        parts = {k: op_of(k[0]).reference_share(values, params, cache)
                 for k, params in qs.items()}
        del values, cache
        got = ranks.gather(parts)
        if got is not None:
            out[column] = {k: op_of(k[0]).join([g[k] for g in got], params)
                           for k, params in qs.items()}
    return out if ranks.rank == 0 else None


def digest(answer) -> str:
    """A digest of an answer's dtype, shape and bytes (a tensor, an array,
    a numpy scalar or a Python number)."""
    if hasattr(answer, "detach"):
        answer = answer.detach().cpu().numpy()
    a = np.asarray(answer)
    if a.dtype == object:
        raise TypeError(f"no digest of a {type(answer).__name__}")
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def disagreeing(mine: dict, others: list) -> int:
    """The answers of ``mine`` (index -> digest) that some other rank's
    digests (``others``) lack or give otherwise."""
    return sum(any(d.get(i) != h for d in others) for i, h in mine.items())


def passed(numbers: dict) -> bool:
    return all(v <= limit for v, limit in numbers.values())


def lines(numbers: dict) -> list:
    return [f"check {n}: {v} (limit {limit})"
            for n, (v, limit) in numbers.items()]
