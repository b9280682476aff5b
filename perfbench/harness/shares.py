"""The resident shares of the ops of a cell on several cards.

Each rank holds only its own run of whole rowgroups of a column (``col``,
which ``cell.run_ranks`` compressed from the rank's rows).  The port's
sharded queries take it as an ``alp_tpu_torch.parallel.ColumnShare``:
the rank's column, the index of its first row and the whole column's
length.  Making one is collective (every rank checks, in one gather, that
the shares tile the column), and every rank makes it at the same request,
since every rank runs the same stream; so ``of`` makes it once a column
and keeps it for the column's later requests.
"""

from __future__ import annotations

_KEPT: dict = {}        # id(col) -> its ColumnShare


def of(col, ranks):
    """The rank's ``ColumnShare`` of ``col`` (``ranks``: the op's fifth
    argument, ``ranks.Ranks``), made at the column's first request."""
    from alp_tpu_torch.parallel import ColumnShare
    sh = _KEPT.get(id(col))
    if sh is None or sh.col is not col:
        sh = _KEPT[id(col)] = ColumnShare(col, ranks.rows[0], ranks.n_total,
                                          ranks.mesh)
    return sh
