"""One Adam iteration of a state transfer: V initial states carried to
their targets, with no squaring (the upstream pre-pass forces none), so
the series is applied to the columns: (q - 1) products of 2 M^2 a column
and a step, forward and in the adjoint.  The rest as for a gate
(``work/gate.py``)."""

from . import gate


def per_seed(sizes):
    return gate.per_seed(dict(sizes, squarings=0))
