"""What decides ``correct``: the answers of the window against the plain
reference.

After the window, with the program's state freed, each column's values
are generated again from the seed.  Every kept answer is held against the
reference's answer to the same question (one reference a distinct
question), by the numbers its op names (``NUMBERS``: name -> limit).  Two
numbers are the harness's own: ``unanswered``, the requests that raised,
and ``unchecked``, the templates of the window with no answer checked.
Each number is the largest over the answers; each limit is 0.
"""

from __future__ import annotations

import collections

HARNESS_NUMBERS = {"unanswered": 0, "unchecked": 0}


def check(records, answers: dict, op_of, values_of) -> tuple:
    """``records`` of the window, ``answers`` (record index -> answer),
    ``op_of(name)`` the op modules, ``values_of(column)`` the column's
    generated values.  Returns ({number: (value, limit)}, checked)."""
    numbers = dict(HARNESS_NUMBERS)
    value = {name: 0 for name in numbers}
    by_column = collections.defaultdict(list)
    for r in records:
        if r.index in answers:
            by_column[r.column].append(r)
        op = op_of(r.op)
        for name, limit in op.NUMBERS.items():
            if numbers.setdefault(name, limit) != limit:
                raise ValueError(f"number {name!r} has two limits")
            value.setdefault(name, 0)
    value["unanswered"] = sum(not r.ok for r in records)
    templates = {r.template for r in records}
    seen = set()
    checked = 0
    for column, recs in by_column.items():
        values = values_of(column)
        cache, expected = {}, {}
        for r in recs:
            op = op_of(r.op)
            k = (r.op, op.key(r.params))
            if k not in expected:
                expected[k] = op.reference(values, r.params, cache)
            for name, v in op.compare(answers[r.index], expected[k]).items():
                value[name] = max(value[name], v)
            seen.add(r.template)
            checked += 1
        del values, cache, expected
    value["unchecked"] = len(templates - seen)
    return {n: (value[n], numbers[n]) for n in numbers}, checked


def passed(numbers: dict) -> bool:
    return all(v <= limit for v, limit in numbers.values())


def lines(numbers: dict) -> list:
    return [f"check {n}: {v} (limit {limit})"
            for n, (v, limit) in numbers.items()]
