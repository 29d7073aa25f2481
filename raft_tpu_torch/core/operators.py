"""Composable math operators (counterpart of ``raft_tpu.core.operators``).

RAFT's operator functors (core/operators.hpp: identity, sq_op, abs_op,
add_op, ..., and the ``compose_op`` / ``map_args_op`` / ``const_op`` /
``plug_const_op`` combinators) as plain Python callables over tensors, so
code written against RAFT's vocabulary (``linalg.map(operators.sq_op, x)``)
reads the same in the port.
"""

from __future__ import annotations

import torch


def identity_op(x):
    return x


def sq_op(x):
    return x * x


def abs_op(x):
    return torch.abs(x)


def sqrt_op(x):
    return torch.sqrt(x)


def nz_op(x):
    """1 where nonzero else 0, in x's dtype (core/operators.hpp nz_op)."""
    return torch.where(x != 0, 1, 0).to(x.dtype)


def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def div_checkzero_op(a, b):
    """a/b with 0 where b == 0 (core/operators.hpp div_checkzero_op)."""
    return torch.where(b == 0, 0, a / torch.where(b == 0, 1, b))


def min_op(a, b):
    return torch.minimum(a, b)


def max_op(a, b):
    return torch.maximum(a, b)


def pow_op(a, b):
    return a ** b


def mod_op(a, b):
    return a % b


def equal_op(a, b):
    return a == b


def notequal_op(a, b):
    return a != b


def greater_op(a, b):
    return a > b


def less_op(a, b):
    return a < b


def const_op(c):
    """An op that ignores its inputs (core/operators.hpp const_op)."""
    return lambda *args: c


def compose_op(*ops):
    """compose_op(f, g, h)(x) == f(g(h(x))): the last op is applied first,
    as in core/operators.hpp compose_op."""

    def composed(*args):
        out = ops[-1](*args)
        for f in reversed(ops[:-1]):
            out = f(out)
        return out

    return composed


def plug_const_op(c, op):
    """Binds a constant as the second argument (plug_const_op)."""
    return lambda x: op(x, c)


add_const_op = lambda c: plug_const_op(c, add_op)  # noqa: E731
sub_const_op = lambda c: plug_const_op(c, sub_op)  # noqa: E731
mul_const_op = lambda c: plug_const_op(c, mul_op)  # noqa: E731
div_const_op = lambda c: plug_const_op(c, div_op)  # noqa: E731
pow_const_op = lambda c: plug_const_op(c, pow_op)  # noqa: E731


def map_args_op(op, *maps):
    """Applies a transform to each argument before ``op`` (map_args_op)."""

    def mapped(*args):
        return op(*(m(a) for m, a in zip(maps, args)))

    return mapped
