"""Deferred scalars.

JAX analog of the reference's ``Scalar<T>`` (reference: Scalar.hpp:11-72,
Scalar.cpp:26-116), which wraps a Legion future and overloads arithmetic so
solver drivers never block.  Under ``jax.jit`` a traced 0-d array *is* a
future: arithmetic on it builds the XLA dependency graph and nothing blocks
until someone materializes a value, so this class is a thin wrapper kept for
API parity and for the future-ratio ("get_alpha") protocol.

The reference passes axpy/xpay coefficients as *unevaluated ratios of futures*
so leaf tasks compute the division locally (reference: LegionUtilities.cpp:72-97,
``get_alpha``: 0 futures -> 1, 1 -> f0, 2 -> f0/f1, 3 -> (f0*f1)/f2,
4 -> (f0*f1)/(f2*f3)).  :func:`alpha_from_scalars` reproduces that protocol
exactly; under jit the divisions fuse into the consuming kernel anyway.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax.numpy as jnp

Number = Union[int, float, "Scalar"]


class Scalar:
    """A deferred scalar value: wraps a 0-d jax array (or python number while
    outside a trace).  All arithmetic stays on device / in the trace."""

    __slots__ = ("value",)

    def __init__(self, value):
        if isinstance(value, Scalar):
            value = value.value
        self.value = jnp.asarray(value)

    # -- arithmetic (reference: Scalar.cpp:26-94) --------------------------
    def _lift(self, other: Number) -> jnp.ndarray:
        return other.value if isinstance(other, Scalar) else jnp.asarray(
            other, dtype=self.value.dtype
        )

    def __add__(self, other: Number) -> "Scalar":
        return Scalar(self.value + self._lift(other))

    __radd__ = __add__

    def __sub__(self, other: Number) -> "Scalar":
        return Scalar(self.value - self._lift(other))

    def __rsub__(self, other: Number) -> "Scalar":
        return Scalar(self._lift(other) - self.value)

    def __mul__(self, other: Number) -> "Scalar":
        return Scalar(self.value * self._lift(other))

    __rmul__ = __mul__

    def __truediv__(self, other: Number) -> "Scalar":
        return Scalar(self.value / self._lift(other))

    def __rtruediv__(self, other: Number) -> "Scalar":
        return Scalar(self._lift(other) / self.value)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.value)

    def sqrt(self) -> "Scalar":
        return Scalar(jnp.sqrt(self.value))

    def rsqrt(self) -> "Scalar":
        return Scalar(jnp.reciprocal(jnp.sqrt(self.value)))

    # -- materialization ---------------------------------------------------
    def get_value(self) -> float:
        """Blocking read — the analog of ``Future::get_result``.  Only legal
        outside a jit trace; inside a trace, keep composing instead."""
        return float(self.value)

    def print(self, dummy=None):
        """Print the value (reference: Scalar.cpp:96-116 chains on a future to
        order output; eager jax is already ordered)."""
        print(f"{self.get_value():g}")
        return dummy

    def __repr__(self) -> str:
        return f"Scalar({self.value!r})"


class ScalarHistory(list):
    """A list of :class:`Scalar` materialized lazily from one device array.

    Compiled solver loops return their whole residual history as a single
    device array; wrapping every element in a Scalar eagerly costs one
    device-op dispatch per element, per solver iteration.  This defers the
    per-element indexing until someone actually reads the
    history: ``[-1]`` costs a single device gather, bulk iteration does one
    host fetch, and benchmark loops that never read it pay nothing.

    ``append``/``extend`` compose with lazy slots; every other list
    operation (equality, ``in``, ``reversed``, ``repr``, index-shifting
    mutation like ``insert``/``pop``/``remove``/``sort``) materializes the
    whole history first so cached slots can never desynchronize from the
    backing array."""

    def __init__(self, arr):
        super().__init__([None] * int(arr.shape[0]))
        self._arr = arr

    def _get(self, i: int) -> Scalar:
        v = list.__getitem__(self, i)
        if v is None:
            v = Scalar(self._arr[i])
            list.__setitem__(self, i, v)
        return v

    def _materialize_all(self):
        import numpy as np

        missing = [i for i in range(len(self))
                   if list.__getitem__(self, i) is None]
        if missing:  # one host fetch instead of len(self) device gathers
            vals = np.asarray(self._arr)
            for i in missing:
                list.__setitem__(self, i, Scalar(vals[i]))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._get(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
            if i < 0:
                raise IndexError("ScalarHistory index out of range")
        return self._get(i)

    def __iter__(self):
        self._materialize_all()
        return super().__iter__()

    def __reversed__(self):
        self._materialize_all()
        return super().__reversed__()

    def __repr__(self):
        self._materialize_all()
        return f"ScalarHistory({list.__repr__(self)})"

    def __eq__(self, other):
        self._materialize_all()
        if isinstance(other, ScalarHistory):
            other._materialize_all()
        return list.__eq__(self, other)

    __hash__ = None

    def __contains__(self, item):
        self._materialize_all()
        return super().__contains__(item)

    def _mat_then(name):
        def method(self, *a, **kw):
            self._materialize_all()
            return getattr(list, name)(self, *a, **kw)

        method.__name__ = name
        return method

    index = _mat_then("index")
    count = _mat_then("count")
    insert = _mat_then("insert")
    remove = _mat_then("remove")
    pop = _mat_then("pop")
    sort = _mat_then("sort")
    reverse = _mat_then("reverse")
    __setitem__ = _mat_then("__setitem__")
    __delitem__ = _mat_then("__delitem__")
    del _mat_then


def alpha_from_scalars(scalars: Sequence[Scalar]) -> jnp.ndarray:
    """The reference's future-ratio protocol (LegionUtilities.cpp:72-97).

    0 scalars -> 1;  1 -> s0;  2 -> s0/s1;  3 -> (s0*s1)/s2;
    4 -> (s0*s1)/(s2*s3).  Anything else is an error, as in the reference.
    """
    vals = [s.value if isinstance(s, Scalar) else jnp.asarray(s) for s in scalars]
    if len(vals) == 0:
        return jnp.asarray(1.0)
    if len(vals) == 1:
        return vals[0]
    if len(vals) == 2:
        return vals[0] / vals[1]
    if len(vals) == 3:
        return (vals[0] * vals[1]) / vals[2]
    if len(vals) == 4:
        return (vals[0] * vals[1]) / (vals[2] * vals[3])
    raise ValueError(f"alpha_from_scalars: got {len(vals)} scalars, expected 0-4")
