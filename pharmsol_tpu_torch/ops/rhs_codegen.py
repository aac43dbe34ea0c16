"""Generate the CUDA right-hand side of an ODE model from its torch closure.

The fused ODE kernel (``csrc/fused_ode.cu``) runs the user's RHS
``diffeq(x, p, t, b, rateiv, cov) -> dx`` inside every Runge-Kutta stage of
every thread, so the RHS has to be device code. This module traces the
closure once with symbolic scalars and emits it as one straight-line C++
function, which the kernel's build includes:

    template <typename T>
    __device__ __forceinline__ void rhs(const T* x, const T* p, T t,
                                        const T* b, const T* rateiv,
                                        const T* cov_a, const T* cov_b, T* dx);

It is the counterpart of three pieces of the JAX package: the lane shim
``ops/pallas_ode.py::make_lane_rhs`` (which traced the closure straight into
the TPU kernel), its stacked-array fallback ``make_stacked_rhs`` (:495) and
the plan-time probe kernel ``likelihood/plans/ode.py::_probe_kernel`` (which
rejected RHS styles the TPU compiler could not lower). Here acceptance is the
generator's own job: what it cannot express raises
:class:`~pharmsol_tpu_torch.errors.PharmsolError` with the reason at plan
time, and ``engine='auto'`` then takes the general engine and records why.

Two closure styles, tried in the JAX plan's order (:412-460):

- ``"lanes"``: the closure's vectors are lists of per-state scalars (static
  integer indexing, slicing, iteration) and its result a list, a tuple or
  ``torch.stack([...])``. Every model that traces so keeps this style, its
  header and its key; the fused twins call it with lists of lanes.
- ``"stacked"``, only where the closure fails on lists: its vectors are
  value vectors, as a 1-D tensor is: ``torch.zeros_like`` / ``ones_like`` /
  ``full_like``, ``torch.zeros(n)`` / ``ones(n)``, constant 1-D tensors,
  ``v[i] = e``, ``v[i] += e`` and slice assignment with static indices,
  slicing, elementwise arithmetic between a vector and a scalar or vectors
  of one length (another length raises), the unary functions below
  elementwise, ``torch.cat`` of vectors, ``torch.stack`` of scalars and
  ``sum`` over the state axis. The trace stays functional: a write makes
  a new item, and an add of 0, a product with 1 where a write lands on a
  vector ``zeros_like`` or ``ones_like`` made is folded, so a vector-style
  spelling traces to the graph, header and key of its list-style spelling.
  The twins call such a closure under ``torch.func.vmap`` over the lanes, as
  the general engine does, so a reduction sums the states of one lane (the
  JAX ``make_stacked_rhs`` hands ``[n, rows, sp]`` arrays, and its
  ``x.sum()`` sums across lanes too). A write of a traced value into a
  tensor no argument batches (``torch.zeros(n)``, ``torch.tensor``) is
  refused: ``vmap`` cannot run it.

Operations: ``+ - * /``, unary ``-``, ``**`` (also with an exponent that
depends on the state), ``torch.exp``, ``torch.log``, ``torch.sqrt``,
``torch.abs``/``abs``, ``torch.floor``, ``torch.ceil``, ``torch.round`` (half
to even), ``torch.sin``, ``torch.cos``, ``torch.tan``, ``torch.log10``,
``torch.log2`` (the DSL's intrinsics), ``torch.tanh``, ``sinh``, ``cosh``,
``asin``, ``acos``, ``atan``, ``atan2``, ``sigmoid``, ``log1p``, ``expm1``,
``erf``, ``erfc``, ``square``, ``rsqrt``, ``reciprocal``, ``sign`` (and their
``torch.special`` and ``arc*`` names), ``torch.minimum``, ``torch.maximum``,
``torch.clamp``, ``torch.where`` with comparisons (and ``& | ~`` on them),
Python float constants, static integer indexing ``x[i]``, ``p[i]``,
``b[j]``, ``rateiv[j]`` and covariate reads ``cov(name, t)`` of the
covariates the generator is given. Rejected: a Python ``if`` (or
``min``/``max``, ``and``/``or``) on a traced value, a conversion of one to a
Python number (``float``, ``math.*``), data-dependent indexing, writes into
the closure's own arguments, reads of an unknown covariate and any other
operation.

Covariates (the counterpart of the JAX kernel's ``LaneCov``,
``ops/pallas_ode.py:417``): the kernel hands the RHS two arrays, ``cov_a``
and ``cov_b``, one entry per covariate in the order given. A covariate in
mode ``const`` is constant over the row and reads as ``cov_a[i]``; one in
mode ``affine`` is affine within the segment, ``cov(t) = cov_a[i] +
cov_b[i] * t`` at the time the closure passes, so a read at a shifted time
is exact too. The SDE generator takes covariates the same way: its drift
and diffusion get the same two arrays.

Jacobian columns (``generate_rhs(..., jacobian=True)``): the implicit and
exact tiers of the kernel need ``df/dx``, which the JAX kernel takes by
``jax.jvp`` of the lane closure. Here the recorded graph is differentiated
symbolically in forward mode with respect to the state (:func:`tangents`,
one rule per operation in ``_JVP_RULES``), and the header gains a second
function

    template <typename T>
    __device__ __forceinline__ void rhs_jvp(const T* x, const T* p, T t,
                                            const T* b, const T* rateiv,
                                            const T* cov_a, const T* cov_b,
                                            const T* v, T* jv);

with ``jv = (df/dx)(x) v`` and the macro ``PHARMSOL_RHS_HAS_JVP``. Nothing is
differenced. An operation without a rule raises PharmsolError with the
reason. The flag is part of the header, so of its key and of the library's
name: a model's explicit-tier library is the same with or without it.

Covariate-only terms (headers without ``rhs_jvp``, for the explicit tier):
where subexpressions that read only parameters, constants and covariate
values feed the rest of the RHS and cost more than one operation (the
reference's ``p[1] * (creatinine / 75) ** 0.75 * (age / 25) ** 0.5``), the
header also holds

    template <typename T>
    __device__ __forceinline__ void rhs_pre(const T* p, T t, const T* cov_a,
                                            const T* cov_b, T* pre);
    template <typename T>
    __device__ __forceinline__ void rhs_body(const T* x, const T* p, T t,
                                             const T* b, const T* rateiv,
                                             const T* cov_a, const T* cov_b,
                                             const T* pre, T* dx);

with ``PHARMSOL_RHS_NPRE`` terms (:func:`covariate_only_terms`): ``rhs_body``
after ``rhs_pre`` evaluates rhs's own expressions in its order, so it gives
rhs's values, and where no covariate has a slope ``pre`` does not depend on
``t``: the kernel computes it once per run and keeps it in registers.

After tracing, the recorded graph is evaluated in float64 on random inputs
and held against the closure itself (a stacked closure under ``vmap``, as
the twins call it), so a closure that behaves differently under tracing is
rejected too. Nothing here needs a compiler or a card.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..errors import PharmsolError


class GeneratedRhs(NamedTuple):
    """The closure and the C++ header generated from it."""

    diffeq: Callable
    n_states: int
    n_params: int
    ninput: int
    source: str  # the C++ header text
    key: str  # content hash of ``source``
    cov_names: tuple = ()  # the covariates of cov_a / cov_b, in order
    cov_modes: tuple = ()  # "const" or "affine" per covariate
    jacobian: bool = False  # the header also holds rhs_jvp
    n_pre: int = 0  # covariate-only terms of rhs_pre / rhs_body (0: rhs alone)
    style: str = "lanes"  # "lanes" (lists of per-state lanes) or "stacked" (vectors)


class GeneratedSde(NamedTuple):
    """An SDE's drift and diffusion closures and the C++ header generated
    from them."""

    drift: Callable
    diffusion: Callable
    n_states: int
    n_params: int
    ninput: int
    source: str
    key: str
    cov_names: tuple = ()  # the covariates of cov_a / cov_b, in order
    cov_modes: tuple = ()  # "const" or "affine" per covariate
    zero_diffusion: frozenset = frozenset()  # components traced to a literal 0


# ---------------------------------------------------------------------------
# Symbolic scalars
# ---------------------------------------------------------------------------

_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_BOOL_OPS = {"and": "&&", "or": "||"}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


class _VectorStyle(PharmsolError):
    """The closure uses vector-style code, which the lane tracer does not
    take: the ODE generator traces it again with value vectors."""


# whether the trace runs with value vectors (the "stacked" style)
_VALUE_VECTORS = False


class Sym:
    """One scalar of the traced RHS: a leaf (state, parameter, time, bolus,
    rate, constant) or an operation on other Syms. ``fill`` marks a constant
    that ``zeros_like`` and the like made, which arithmetic folds away."""

    __slots__ = ("op", "args", "value", "is_bool", "fill")

    def __init__(self, op, args=(), value=None, is_bool=False, fill=False):
        self.op = op
        self.args = tuple(args)
        self.value = value
        self.is_bool = is_bool
        self.fill = fill

    # -- dispatch of torch functions ------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _torch_op(func, args, kwargs or {})

    # -- Python operators --------------------------------------------------------
    def __add__(self, o):
        return _arith("add", self, o)

    def __radd__(self, o):
        return _arith("add", o, self)

    def __sub__(self, o):
        return _arith("sub", self, o)

    def __rsub__(self, o):
        return _arith("sub", o, self)

    def __mul__(self, o):
        return _arith("mul", self, o)

    def __rmul__(self, o):
        return _arith("mul", o, self)

    def __truediv__(self, o):
        return _arith("div", self, o)

    def __rtruediv__(self, o):
        return _arith("div", o, self)

    def __pow__(self, o):
        return _pow(self, o)

    def __rpow__(self, o):
        return _pow(o, self)

    def __neg__(self):
        return Sym("neg", (_num(self),))

    def __pos__(self):
        return self

    def __abs__(self):
        return Sym("abs", (_num(self),))

    def __lt__(self, o):
        return _cmp("lt", self, o)

    def __le__(self, o):
        return _cmp("le", self, o)

    def __gt__(self, o):
        return _cmp("gt", self, o)

    def __ge__(self, o):
        return _cmp("ge", self, o)

    def __eq__(self, o):
        return _cmp("eq", self, o)

    def __ne__(self, o):
        return _cmp("ne", self, o)

    __hash__ = object.__hash__

    def __and__(self, o):
        return _logic("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logic("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        return Sym("not", (_as_bool(self),), is_bool=True)

    # -- what tracing cannot follow -----------------------------------------------
    def __bool__(self):
        raise PharmsolError(
            "the RHS branches on a traced value (a Python `if`, `and`/`or`, "
            "builtin `min`/`max` or a comparison used as a bool): use "
            "torch.where, torch.minimum or torch.maximum"
        )

    def __float__(self):
        raise PharmsolError(
            "the RHS converts a traced value to a Python number (float(), "
            "math.*): use the torch functions (torch.exp, torch.log, ...)"
        )

    __int__ = __index__ = __float__

    def __getitem__(self, idx):
        raise PharmsolError("the RHS indexes a scalar (x[i][j])")

    def __setitem__(self, idx, value):
        raise PharmsolError("the RHS writes in place into a traced value")

    def __repr__(self):
        return f"Sym({self.op})"


_UNBATCHED_WRITE = (
    "the RHS writes a traced value in place into a tensor that no argument of "
    "the closure batches (torch.zeros(n), torch.tensor): the engines call the "
    "closure under vmap, which cannot; start from torch.zeros_like(x)")


def _lanes_only(what: str):
    """Refuse vector-style code under the lane tracer (the ODE generator then
    traces the closure again with value vectors)."""
    if not _VALUE_VECTORS:
        raise _VectorStyle(f"the RHS {what}")


class SymVec:
    """A traced vector (``x``, ``p``, ``b``, ``rateiv``, a stacked result or,
    in the stacked style, any vector the closure makes). Under the lane
    tracer it takes what a list takes: static integer indexing, slicing,
    iteration. Under the value-vector tracer it is a 1-D tensor of Syms:
    writes with static indices (not into the closure's own arguments, the
    ``readonly`` ones), elementwise arithmetic and functions, ``sum`` over
    its one axis. ``batched`` says whether ``vmap`` over the lanes batches
    it: the arguments and whatever derives from them do; ``torch.zeros(n)``
    does not, and a traced value cannot be written into it."""

    def __init__(self, items, name: str = "vector", batched: bool = True,
                 readonly: bool = False):
        self._items = list(items)
        self._name = name
        self._batched = batched
        self._readonly = readonly

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _torch_op(func, args, kwargs or {})

    def _index(self, idx) -> list:
        """The static positions ``idx`` selects, or an int for one item."""
        n = len(self._items)
        if isinstance(idx, slice):
            return list(range(n))[idx]
        if isinstance(idx, (int, np.integer)) and not isinstance(idx, bool):
            if not -n <= idx < n:
                raise PharmsolError(
                    f"the RHS reads {self._name}[{idx}], out of range "
                    f"({n} entries)"
                )
            return int(idx) % n
        raise PharmsolError(
            f"the RHS indexes {self._name} with a {type(idx).__name__}: "
            "only static integer indices are supported (no data-dependent "
            "indexing)"
        )

    def __getitem__(self, idx):
        at = self._index(idx)
        if isinstance(at, int):
            return self._items[at]
        return SymVec([self._items[i] for i in at], self._name, self._batched)

    def __setitem__(self, idx, value):
        _lanes_only(f"writes in place into {self._name}")
        if self._readonly:
            raise PharmsolError(
                f"the RHS writes in place into its argument {self._name}: "
                f"write into a copy (torch.zeros_like({self._name}))")
        at = self._index(idx)
        if isinstance(at, int):
            vals = _items_of(value)
            if vals is not None and len(vals) != 1:
                raise PharmsolError(
                    f"the RHS writes {len(vals)} values into one entry of {self._name}")
            new = {at: _num(vals[0] if vals is not None else value)}
        else:
            vals = _items_of(value)
            if vals is None:
                vals = [value] * len(at)
            if len(vals) != len(at):
                raise PharmsolError(
                    f"the RHS writes {len(vals)} values into {len(at)} entries of "
                    f"{self._name} (vectors of different lengths)")
            new = {i: _num(v) for i, v in zip(at, vals)}
        if not self._batched and any(v.op != "const" for v in new.values()):
            raise PharmsolError(_UNBATCHED_WRITE)
        for i, v in new.items():
            self._items[i] = v

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def _vector_arith(self, *_):
        raise _VectorStyle(
            f"the RHS does whole-vector arithmetic on {self._name}: write "
            "each component with static indices and torch.stack them"
        )

    def _binary(op, reflected=False):
        def method(self, o):
            if not _VALUE_VECTORS:
                self._vector_arith()
            a, b = (o, self) if reflected else (self, o)
            return _pow(a, b) if op == "pow" else _arith(op, a, b)
        return method

    __add__, __radd__ = _binary("add"), _binary("add", True)
    __sub__, __rsub__ = _binary("sub"), _binary("sub", True)
    __mul__, __rmul__ = _binary("mul"), _binary("mul", True)
    __truediv__, __rtruediv__ = _binary("div"), _binary("div", True)
    __pow__, __rpow__ = _binary("pow"), _binary("pow", True)
    del _binary

    def __neg__(self):
        if not _VALUE_VECTORS:
            self._vector_arith()
        return _elementwise(lambda u: Sym("neg", (_num(u),)), self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _torch_op(torch.abs, (self,), {})

    def _compare(op):
        def method(self, o):
            _lanes_only(f"compares {self._name} as a vector")
            return _cmp(op, self, o)
        return method

    __lt__, __le__, __gt__ = _compare("lt"), _compare("le"), _compare("gt")
    __ge__, __eq__, __ne__ = _compare("ge"), _compare("eq"), _compare("ne")
    __hash__ = object.__hash__
    del _compare

    def sum(self, dim=None, keepdim=False, dtype=None):
        _lanes_only(f"sums {self._name}")
        if dim not in (None, 0, -1, (0,), (-1,)) or keepdim:
            raise PharmsolError(
                f"the RHS sums {self._name} over dim={dim} (keepdim={keepdim}): "
                "only the state axis (dim 0) is summed")
        if not self._items:
            return _const(0.0)
        acc = self._items[0]
        for v in self._items[1:]:
            acc = _arith("add", acc, v)
        return _num(acc)

    # what vector code reads of a tensor (x.shape[0], dtype=x.dtype, ...)
    @property
    def shape(self):
        _lanes_only(f"reads the shape of {self._name}")
        return torch.Size([len(self._items)])

    @property
    def dtype(self):
        _lanes_only(f"reads the dtype of {self._name}")
        return torch.float64

    @property
    def device(self):
        _lanes_only(f"reads the device of {self._name}")
        return torch.device("cpu")

    def __repr__(self):
        return f"SymVec({self._name}, {len(self._items)})"


def _const(v) -> Sym:
    return Sym("const", value=float(v))


def _fill(v) -> Sym:
    return Sym("const", value=float(v), fill=True)


def _items_of(v):
    """The items of a vector operand (a SymVec, a 1-D constant tensor, a list
    or tuple in the stacked style), or None for a scalar."""
    if isinstance(v, SymVec):
        return v._items
    if isinstance(v, torch.Tensor) and v.dim() == 1 and not v.requires_grad:
        return [_const(c) for c in v.tolist()]
    if isinstance(v, (list, tuple)) and _VALUE_VECTORS:
        return list(v)
    return None


def _is_vector(v) -> bool:
    return (isinstance(v, SymVec)
            or (isinstance(v, torch.Tensor) and v.dim() == 1 and not v.requires_grad))


def _is_batched(v) -> bool:
    if isinstance(v, SymVec):
        return v._batched
    return isinstance(v, Sym) and not v.args and v.op not in ("const", "bconst")


def _elementwise(fn, *args):
    """``fn`` of scalars applied item by item where an argument is a vector
    (scalars broadcast; vectors must have one length)."""
    if not any(_is_vector(a) for a in args):
        return fn(*args)
    _lanes_only("does elementwise arithmetic on a vector")
    items = [_items_of(a) if _is_vector(a) else None for a in args]
    lengths = sorted({len(v) for v in items if v is not None})
    if len(lengths) > 1:
        raise PharmsolError(
            f"the RHS combines vectors of lengths {lengths} elementwise")
    out = [fn(*[v[i] if v is not None else a for v, a in zip(items, args)])
           for i in range(lengths[0])]
    batched = any(_is_batched(a) or (isinstance(a, Sym) and a.args) for a in args)
    return SymVec(out, "a vector", batched=batched)


def _num(v) -> Sym:
    """An operand of arithmetic: a float Sym (bools are cast)."""
    if isinstance(v, Sym):
        return Sym("cast", (v,)) if v.is_bool else v
    if isinstance(v, (bool, np.bool_)):
        return _const(float(v))
    if isinstance(v, (int, float, np.integer, np.floating)):
        return _const(v)
    if isinstance(v, torch.Tensor) and v.dim() == 0 and not v.requires_grad:
        return _const(v.item())
    if isinstance(v, SymVec):
        if not _VALUE_VECTORS:
            v._vector_arith()
        raise PharmsolError(f"the RHS uses the vector {v._name} where a scalar is needed")
    raise PharmsolError(f"the RHS combines a traced value with a {type(v).__name__}")


def _as_bool(v) -> Sym:
    if isinstance(v, Sym) and v.is_bool:
        return v
    if isinstance(v, (bool, np.bool_)):
        return Sym("bconst", value=bool(v), is_bool=True)
    raise PharmsolError("a logical operator (& | ~) on a non-comparison")


def _is_fill(v, value: float) -> bool:
    return isinstance(v, Sym) and v.fill and v.value == value


def _fold(op, a: Sym, b: Sym):
    """``a op b`` where one side is a fill that leaves the other unchanged,
    ``0 + e``, ``e + 0``, ``1 * e``, ``e * 1`` (a write onto a vector
    zeros_like or ones_like made), else None."""
    if op == "add":
        if _is_fill(a, 0.0):
            return b
        if _is_fill(b, 0.0):
            return a
    elif op == "mul":
        if _is_fill(a, 1.0):
            return b
        if _is_fill(b, 1.0):
            return a
    return None


def _arith(op, a, b):
    def scalar(u, w):
        u, w = _num(u), _num(w)
        folded = _fold(op, u, w)
        return Sym(op, (u, w)) if folded is None else folded

    return _elementwise(scalar, a, b)


def _pow(a, b):
    return _elementwise(lambda u, w: Sym("pow", (_num(u), _num(w))), a, b)


def _cmp(op, a, b):
    return _elementwise(lambda u, w: Sym(op, (_num(u), _num(w)), is_bool=True), a, b)


def _logic(op, a, b) -> Sym:
    return Sym(op, (_as_bool(a), _as_bool(b)), is_bool=True)


# unary torch functions the generator emits, by Sym op name
_UNARY_FUNCS = {"exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs,
                "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
                "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
                "log10": torch.log10, "log2": torch.log2,
                "tanh": torch.tanh, "sinh": torch.sinh, "cosh": torch.cosh,
                "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
                "sigmoid": torch.sigmoid, "log1p": torch.log1p, "expm1": torch.expm1,
                "erf": torch.erf, "erfc": torch.erfc, "square": torch.square,
                "rsqrt": torch.rsqrt, "reciprocal": torch.reciprocal, "sign": torch.sign}
# binary torch functions beyond + - * / ** (the Sym op name of each)
_BINARY_FUNCS = {"atan2": torch.atan2, "min": torch.minimum, "max": torch.maximum}
# the same functions under their other torch names
_ALIASES = {torch.arcsin: "asin", torch.arccos: "acos", torch.arctan: "atan",
            torch.arctan2: "atan2", torch.special.expit: "sigmoid",
            torch.special.erf: "erf", torch.special.erfc: "erfc",
            torch.special.expm1: "expm1", torch.special.log1p: "log1p",
            torch.negative: "neg", torch.neg: "neg"}
# Tensor-method and torch-function names of + - * / ** and the comparisons
# (a tensor operand dispatches to the traced one under these names);
# reflected ones swap their operands
_ARITH_NAMES = {"add": "add", "sub": "sub", "mul": "mul", "div": "div", "pow": "pow",
                "__radd__": "radd", "__rsub__": "rsub", "__rmul__": "rmul",
                "__rdiv__": "rdiv", "__rtruediv__": "rdiv", "__rpow__": "rpow"}
_CMP_NAMES = {"lt", "le", "gt", "ge", "eq", "ne"}


def _unary_op_of(func):
    """The Sym op name of a unary torch function or Tensor method, or None."""
    if func in _ALIASES and _ALIASES[func] not in _BINARY_FUNCS:
        return _ALIASES[func]
    name = getattr(func, "__name__", None)
    if name in _UNARY_FUNCS and (func is _UNARY_FUNCS[name]
                                 or func is getattr(torch.Tensor, name, None)):
        return name
    return None


def _vector_of(seq, what: str) -> SymVec:
    """``torch.stack`` of scalars (a SymVec of them)."""
    items = [_num(v) for v in seq]
    return SymVec(items, what, batched=any(v.op != "const" for v in items))


def _made(func, args, kwargs):
    """A vector ``torch.zeros(n)`` or ``ones(n)`` makes under the
    value-vector tracer (a SymVec no argument batches), or None for anything
    else (which then runs as it is)."""
    if func not in (torch.zeros, torch.ones) or len(args) > 1:
        return None  # torch.zeros(2, 3): not a vector
    size = args[0] if args else kwargs.get("size")
    if isinstance(size, (list, tuple, torch.Size)) and len(size) == 1:
        size = size[0]
    if not isinstance(size, (int, np.integer)) or isinstance(size, bool):
        return None
    return SymVec([_fill(0.0 if func is torch.zeros else 1.0) for _ in range(int(size))],
                  "a tensor torch made", batched=False)


def _holds_traced(v) -> bool:
    if isinstance(v, (Sym, SymVec)):
        return True
    if isinstance(v, (list, tuple)):
        return any(_holds_traced(u) for u in v)
    return False


class _ValueVectors(torch.overrides.TorchFunctionMode):
    """The value-vector tracer's view of torch: a call that reads a traced
    value goes to :func:`_torch_op`; ``torch.zeros(n)`` and the like make
    SymVecs (so that writes into them are traced); the rest runs."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _holds_traced(args) or _holds_traced(list(kwargs.values())):
            return _torch_op(func, args, kwargs)
        made = _made(func, args, kwargs)
        return made if made is not None else func(*args, **kwargs)


def _torch_op(func, args, kwargs):
    name = getattr(func, "__name__", str(func))
    kwargs = {k: v for k, v in kwargs.items() if k not in ("dtype", "device", "out")
              or (k == "out" and v is not None)}
    op = _unary_op_of(func)
    if op is not None:
        if kwargs or len(args) != 1:
            raise PharmsolError(f"torch.{name} takes one argument in the RHS")
        (a,) = args
        return _elementwise(lambda u: Sym(op, (_num(u),)), a)
    binary = _ALIASES.get(func) or next(
        (op for op, f in _BINARY_FUNCS.items() if f is func), None)
    if binary is not None:
        a, b = args
        return _elementwise(lambda u, w: Sym(binary, (_num(u), _num(w))), a, b)
    if name in _ARITH_NAMES and len(args) == 2 and not kwargs:
        op = _ARITH_NAMES[name]
        a, b = args
        if op.startswith("r"):
            op, a, b = op[1:], b, a
        return _pow(a, b) if op == "pow" else _arith(op, a, b)
    if name in _CMP_NAMES and len(args) == 2 and not kwargs:
        return _cmp(name, *args)
    if func is torch.clamp:
        a = args[0]
        lo = kwargs.get("min", args[1] if len(args) > 1 else None)
        hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        if lo is not None:
            a = _elementwise(lambda u, w: Sym("max", (_num(u), _num(w))), a, lo)
        if hi is not None:
            a = _elementwise(lambda u, w: Sym("min", (_num(u), _num(w))), a, hi)
        return a
    if func is torch.where:
        if len(args) != 3:
            raise PharmsolError("torch.where needs (condition, a, b)")
        return _elementwise(lambda c, u, w: Sym("where", (_as_bool(c), _num(u), _num(w))),
                            *args)
    if func is torch.stack:
        seq = args[0]
        if args[1:] or kwargs.get("dim", 0) != 0:
            raise PharmsolError("torch.stack of the RHS result must stack along dim 0")
        if any(_is_vector(v) for v in seq):
            raise PharmsolError("the RHS stacks vectors into a matrix: torch.cat them")
        return _vector_of(seq, "the result")
    if func in (torch.zeros_like, torch.ones_like, torch.full_like):
        (a, *rest) = args
        _lanes_only(f"uses `{name}`")
        value = {torch.zeros_like: 0.0, torch.ones_like: 1.0}.get(func)
        if value is None:
            value = rest[0] if rest else kwargs.get("fill_value")
            if not isinstance(value, (int, float, np.integer, np.floating)):
                raise PharmsolError("torch.full_like in the RHS takes a Python number")
        if isinstance(a, Sym):
            return _fill(value)
        return SymVec([_fill(value) for _ in a], "a vector", batched=a._batched)
    if func is torch.cat:
        _lanes_only(f"uses `{name}`")
        if args[1:] or kwargs.get("dim", kwargs.get("axis", 0)) not in (0, -1):
            raise PharmsolError("torch.cat in the RHS joins vectors along dim 0")
        items, batched = [], False
        for v in args[0]:
            got = _items_of(v) if _is_vector(v) else None
            if got is None:
                raise PharmsolError("torch.cat in the RHS joins vectors, not scalars")
            items += got
            batched = batched or _is_batched(v)
        return SymVec(items, "a vector", batched=batched)
    if func is torch.sum or name == "sum":
        a, *rest = args
        if not isinstance(a, SymVec):
            raise PharmsolError("the RHS sums a scalar")
        return a.sum(*rest, **kwargs)
    if name in ("__setitem__", "index_put_", "copy_") or name.endswith("_"):
        if _VALUE_VECTORS:
            raise PharmsolError(_UNBATCHED_WRITE)
        raise _VectorStyle(f"the RHS writes in place into a tensor (`{name}`)")
    raise PharmsolError(f"the RHS uses `{name}`, which the CUDA generator does not support")


COV_MODES = ("const", "affine")


class _SymCov:
    """The covariate argument while tracing: ``cov(name, t)`` is the leaf
    ``cov_a[i]`` for a constant covariate and ``cov_a[i] + cov_b[i] * t``
    for an affine one, with ``t`` the time the closure passed."""

    def __init__(self, names, modes):
        self._index = {n: i for i, n in enumerate(names)}
        self._modes = modes

    def __call__(self, name, t):
        i = self._index.get(str(name))
        if i is None:
            raise PharmsolError(
                f"the closure reads unknown covariate `{name}` (the data carries "
                f"{sorted(self._index) or 'none'})"
            )
        a = Sym("cov_a", value=i)
        if self._modes[i] == "const":
            return a
        return _arith("add", a, _arith("mul", Sym("cov_b", value=i), t))

    value = __call__


class LaneCov:
    """The covariate argument of an RHS evaluated on numbers (the JAX
    kernel's ``LaneCov``, ``ops/pallas_ode.py:417``): each covariate is a
    constant, or an ``(a, b)`` pair with ``cov(t) = a + b t`` inside the
    segment, exact because the plan puts every knot on a breakpoint. The
    fused ODE and SDE twins hand it per-row lanes; the generator's check,
    scalars."""

    def __init__(self, values: dict):
        self._values = values

    def __call__(self, name, t):
        try:
            v = self._values[str(name)]
        except KeyError:
            raise KeyError(f"the closure reads unknown covariate `{name}`") from None
        if isinstance(v, tuple):
            return v[0] + v[1] * t
        return v

    value = __call__


# ---------------------------------------------------------------------------
# Tracing, checking and emission
# ---------------------------------------------------------------------------

# A closure's arguments in call order, before ``cov``: (name, length), length
# None for the scalar time. The C++ function takes them in the same order.
_ODE_ARGS = (("x", "n"), ("p", "np"), ("t", None), ("b", "nin"), ("rateiv", "nin"))
_DRIFT_ARGS = (("x", "n"), ("p", "np"), ("t", None), ("rateiv", "nin"))
_DIFFUSION_ARGS = (("p", "np"), ("t", None))


def _sizes(args, n_states, n_params, ninput):
    dims = {"n": n_states, "np": n_params, "nin": ninput, None: None}
    return tuple((name, dims[size]) for name, size in args)


def _trace(fn, args, n_out: int, what: str = "the RHS", covs=((), ()),
           vectors: bool = False) -> List[Sym]:
    """Trace ``fn`` on symbolic arguments; ``covs`` is ``(names, modes)`` of
    the covariates it may read. ``vectors``: with value vectors (the
    stacked style); without, vector-style code raises :class:`_VectorStyle`."""
    global _VALUE_VECTORS
    leaves = [Sym(name) if size is None
              else SymVec([Sym(name, value=i) for i in range(size)], name, readonly=True)
              for name, size in args]
    _VALUE_VECTORS = vectors
    try:
        if vectors:
            with _ValueVectors():
                out = fn(*leaves, _SymCov(*covs))
        else:
            out = fn(*leaves, _SymCov(*covs))
        if isinstance(out, torch.Tensor) and out.dim() == 1 and not out.requires_grad:
            out = list(out)  # a vector of constants
        if isinstance(out, (SymVec, list, tuple)):
            comps = [_num(c) for c in out]
        else:
            raise PharmsolError(
                f"{what} returns a {type(out).__name__}: return "
                "torch.stack([...]) or a list of components"
            )
    finally:
        _VALUE_VECTORS = False
    if len(comps) != n_out:
        raise PharmsolError(f"{what} returns {len(comps)} components, expected {n_out}")
    return comps


def _topo(outputs: List[Sym], stop=frozenset()) -> List[Sym]:
    """Every non-leaf node, children before parents, each once; the nodes
    whose ids are in ``stop`` count as leaves."""
    order, seen = [], set()
    stack = [(o, False) for o in reversed(outputs)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        leaf = not node.args or id(node) in stop
        if expanded or leaf:
            seen.add(id(node))
            if not leaf:
                order.append(node)
            continue
        stack.append((node, True))
        stack.extend((a, False) for a in reversed(node.args) if id(a) not in seen)
    return order


_TORCH_UNARY = dict(
    _UNARY_FUNCS, neg=torch.neg, **{"not": torch.logical_not},
    cast=lambda a: a.to(torch.float64),
)
_TORCH_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "pow": torch.pow, "min": torch.minimum, "max": torch.maximum,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
    "or": torch.logical_or, "atan2": torch.atan2,
}


def evaluate(outputs: List[Sym], **leaves) -> torch.Tensor:
    """The traced graph on float64 tensors (leading dims broadcast), with the
    closure's arguments by name (``x``, ``p``, ``t``, ...): the reference the
    generated C++ must reproduce."""
    val = {}

    def get(node):
        if node.op == "const":
            return torch.tensor(node.value, dtype=torch.float64)
        if node.op == "bconst":
            return torch.tensor(node.value)
        if node.op in leaves:
            leaf = leaves[node.op]
            return leaf if node.value is None else leaf[..., node.value]
        return val[id(node)]

    for node in _topo(outputs):
        args = [get(a) for a in node.args]
        if node.op == "where":
            val[id(node)] = torch.where(*args)
        elif node.op in _TORCH_UNARY:
            val[id(node)] = _TORCH_UNARY[node.op](args[0])
        else:
            val[id(node)] = _TORCH_BINARY[node.op](*args)
    return torch.stack(torch.broadcast_tensors(*[get(o) for o in outputs]), dim=-1)


# -- forward-mode tangents of the traced graph ---------------------------------
#
# A tangent is a Sym, or None for an exact zero (parameters, time, rates,
# covariates and constants carry none), so an affine RHS differentiates to
# a handful of operations.


def _t_add(a, b):
    if a is None:
        return b
    return a if b is None else Sym("add", (a, b))


def _t_sub(a, b):
    if b is None:
        return a
    return Sym("neg", (b,)) if a is None else Sym("sub", (a, b))


def _t_scale(t, factor):
    return None if t is None else Sym("mul", (t, factor))


def _jvp_mul(node, a, b, da, db):
    return _t_add(_t_scale(da, b), _t_scale(db, a))


def _jvp_div(node, a, b, da, db):
    # d(a / b) = da / b - (a / b) * db / b
    first = None if da is None else Sym("div", (da, b))
    second = None if db is None else Sym("div", (Sym("mul", (node, db)), b))
    return _t_sub(first, second)


def _jvp_pow(node, a, b, da, db):
    # d(a^u) = u a^(u-1) da + a^u ln(a) du; ln taken at 1 where a == 0, as
    # JAX's rule (0 there; NaN where a < 0)
    base = None
    if da is None:
        pass
    elif b.op == "const":
        e = b.value
        if e == 1.0:
            base = da
        elif e == 2.0:
            base = Sym("mul", (Sym("mul", (_const(2.0), a)), da))
        else:
            base = Sym("mul", (Sym("mul", (b, Sym("pow", (a, _const(e - 1.0))))), da))
    else:
        base = Sym("mul", (Sym("mul", (b, Sym("pow", (a, Sym("sub", (b, _const(1.0))))))), da))
    if db is None:
        return base
    safe = Sym("where", (Sym("eq", (a, _const(0.0)), is_bool=True), _const(1.0), a))
    return _t_add(base, Sym("mul", (Sym("mul", (node, Sym("log", (safe,)))), db)))


def _t_div(t, divisor):
    return None if t is None else Sym("div", (t, divisor))


def _one_minus_square(a):
    return Sym("sub", (_const(1.0), Sym("mul", (a, a))))


def _erf_slope(a, sign: float):
    # d erf(a) / da = 2 / sqrt(pi) exp(-a^2); erfc's the negative
    return Sym("mul", (_const(sign * 2.0 / math.sqrt(math.pi)),
                       Sym("exp", (Sym("neg", (Sym("mul", (a, a)),)),))))


def _jvp_atan2(node, y, x, dy, dx):
    # d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
    if dy is None and dx is None:
        return None
    num = _t_sub(_t_scale(dy, x), _t_scale(dx, y))
    return Sym("div", (num, Sym("add", (Sym("mul", (x, x)), Sym("mul", (y, y))))))


def _jvp_abs(node, a, da):
    if da is None:
        return None
    zero = _const(0.0)
    neg = Sym("where", (Sym("lt", (a, zero), is_bool=True), Sym("neg", (da,)), zero))
    return Sym("where", (Sym("gt", (a, zero), is_bool=True), da, neg))


def _jvp_minmax(node, a, b, da, db):
    # the tangent of the operand the result takes; at a tie the mean of the
    # two, as torch's derivative
    if da is None and db is None:
        return None
    zero = _const(0.0)
    ta = zero if da is None else da
    tb = zero if db is None else db
    first, second = (a, b) if node.op == "min" else (b, a)
    tie = Sym("mul", (_const(0.5), Sym("add", (ta, tb))))
    return Sym("where", (Sym("lt", (first, second), is_bool=True), ta,
                         Sym("where", (Sym("lt", (second, first), is_bool=True), tb, tie))))


def _jvp_where(node, c, a, b, da, db):
    if da is None and db is None:
        return None
    zero = _const(0.0)
    return Sym("where", (c, zero if da is None else da, zero if db is None else db))


# operation -> rule(node, *operands, *operand tangents) -> tangent or None
_JVP_RULES = {
    "add": lambda node, a, b, da, db: _t_add(da, db),
    "sub": lambda node, a, b, da, db: _t_sub(da, db),
    "mul": _jvp_mul,
    "div": _jvp_div,
    "pow": _jvp_pow,
    "neg": lambda node, a, da: None if da is None else Sym("neg", (da,)),
    "exp": lambda node, a, da: _t_scale(da, node),
    "log": lambda node, a, da: None if da is None else Sym("div", (da, a)),
    "sqrt": lambda node, a, da: (None if da is None else
                                 Sym("div", (da, Sym("mul", (_const(2.0), node))))),
    "abs": _jvp_abs,
    # piecewise constant: a zero derivative, as torch's
    "floor": lambda node, a, da: None,
    "ceil": lambda node, a, da: None,
    "round": lambda node, a, da: None,
    "sin": lambda node, a, da: _t_scale(da, Sym("cos", (a,))),
    "cos": lambda node, a, da: (None if da is None else
                                Sym("neg", (Sym("mul", (da, Sym("sin", (a,)))),))),
    # d tan = (1 + tan^2) da
    "tan": lambda node, a, da: _t_scale(da, Sym("add", (_const(1.0),
                                                        Sym("mul", (node, node))))),
    "log10": lambda node, a, da: (None if da is None else
                                  Sym("div", (da, Sym("mul", (a, _const(math.log(10.0))))))),
    "log2": lambda node, a, da: (None if da is None else
                                 Sym("div", (da, Sym("mul", (a, _const(math.log(2.0))))))),
    "min": _jvp_minmax,
    "max": _jvp_minmax,
    "where": _jvp_where,
    "cast": lambda node, a, da: None,  # a comparison's value is piecewise constant
    # the elementwise set, each in operations that have rules themselves (the
    # sensitivity tower differentiates the tangents again)
    "tanh": lambda node, a, da: _t_scale(da, Sym("sub", (_const(1.0), Sym("mul", (node, node))))),
    "sinh": lambda node, a, da: _t_scale(da, Sym("cosh", (a,))),
    "cosh": lambda node, a, da: _t_scale(da, Sym("sinh", (a,))),
    "asin": lambda node, a, da: _t_div(da, Sym("sqrt", (_one_minus_square(a),))),
    "acos": lambda node, a, da: (None if da is None else Sym(
        "neg", (Sym("div", (da, Sym("sqrt", (_one_minus_square(a),)))),))),
    "atan": lambda node, a, da: _t_div(da, Sym("add", (_const(1.0), Sym("mul", (a, a))))),
    "atan2": _jvp_atan2,
    "sigmoid": lambda node, a, da: _t_scale(da, Sym("mul", (node, Sym("sub", (_const(1.0),
                                                                            node))))),
    "log1p": lambda node, a, da: _t_div(da, Sym("add", (_const(1.0), a))),
    "expm1": lambda node, a, da: _t_scale(da, Sym("add", (node, _const(1.0)))),
    "erf": lambda node, a, da: _t_scale(da, _erf_slope(a, 1.0)),
    "erfc": lambda node, a, da: _t_scale(da, _erf_slope(a, -1.0)),
    "square": lambda node, a, da: _t_scale(da, Sym("mul", (_const(2.0), a))),
    # d rsqrt = -rsqrt^3 / 2, d (1 / a) = -(1 / a)^2
    "rsqrt": lambda node, a, da: _t_scale(da, Sym("mul", (_const(-0.5), Sym(
        "mul", (node, Sym("mul", (node, node))))))),
    "reciprocal": lambda node, a, da: _t_scale(da, Sym("neg", (Sym("mul", (node, node)),))),
    "sign": lambda node, a, da: None,  # piecewise constant
}


def tangents(outputs: List[Sym], wrt: str = "x", seed: str = "v",
             seed_offset: int = 0) -> List[Sym]:
    """Forward-mode tangents of ``outputs`` with respect to the leaf vector
    ``wrt``: Syms computing ``(d outputs / d wrt) @ seed`` from the leaves
    and the new leaf vector ``seed`` (element i of ``wrt`` seeded by element
    ``i + seed_offset`` of ``seed``). Raises PharmsolError naming an
    operation that has no derivative rule."""
    tan = {}

    def get(node):
        if node.op == wrt:
            return Sym(seed, value=node.value + seed_offset)
        return tan.get(id(node))

    for node in _topo(outputs):
        if node.is_bool:
            continue
        rule = _JVP_RULES.get(node.op)
        if rule is None:
            raise PharmsolError(f"`{node.op}` has no derivative rule in the CUDA generator")
        ops = node.args
        if node.op == "where":
            tan[id(node)] = rule(node, *ops, get(ops[1]), get(ops[2]))
        else:
            tan[id(node)] = rule(node, *ops, *[get(a) for a in ops])
    return [_const(0.0) if get(o) is None else get(o) for o in outputs]


def _literal(v: float) -> str:
    if math.isnan(v):
        return "T(NAN)"
    if math.isinf(v):
        return "T(INFINITY)" if v > 0 else "T(-INFINITY)"
    return f"T({float(v)!r})"


_MATH_PRELUDE = """\
#ifndef PHARMSOL_RHS_MATH
#define PHARMSOL_RHS_MATH
#include <math.h>
__device__ __forceinline__ float pm_exp(float v) { return expf(v); }
__device__ __forceinline__ double pm_exp(double v) { return exp(v); }
__device__ __forceinline__ float pm_log(float v) { return logf(v); }
__device__ __forceinline__ double pm_log(double v) { return log(v); }
__device__ __forceinline__ float pm_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double pm_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float pm_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double pm_abs(double v) { return fabs(v); }
__device__ __forceinline__ float pm_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pm_pow(double a, double b) { return pow(a, b); }
// NaN-propagating, as torch.minimum / torch.maximum
template <typename T>
__device__ __forceinline__ T pm_min(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T pm_max(T a, T b) { return (a > b || a != a) ? a : b; }
#endif
"""

# the device functions of the operations beyond the prelude's, defined in a
# header only where its functions call them (the headers of other models stay
# as they were): each the body for float and for double, of ``v`` (of ``a``
# and ``b`` for atan2); round is half to even, as torch.round (rint in the
# default rounding mode); sigmoid, rsqrt and reciprocal divide as torch does
# on the host
_EXTRA_MATH = {
    "floor": ("floorf(v)", "floor(v)"), "ceil": ("ceilf(v)", "ceil(v)"),
    "round": ("rintf(v)", "rint(v)"),
    "sin": ("sinf(v)", "sin(v)"), "cos": ("cosf(v)", "cos(v)"), "tan": ("tanf(v)", "tan(v)"),
    "log10": ("log10f(v)", "log10(v)"), "log2": ("log2f(v)", "log2(v)"),
    "tanh": ("tanhf(v)", "tanh(v)"), "sinh": ("sinhf(v)", "sinh(v)"),
    "cosh": ("coshf(v)", "cosh(v)"), "asin": ("asinf(v)", "asin(v)"),
    "acos": ("acosf(v)", "acos(v)"), "atan": ("atanf(v)", "atan(v)"),
    "atan2": ("atan2f(a, b)", "atan2(a, b)"),
    "sigmoid": ("1.0f / (1.0f + expf(-v))", "1.0 / (1.0 + exp(-v))"),
    "log1p": ("log1pf(v)", "log1p(v)"), "expm1": ("expm1f(v)", "expm1(v)"),
    "erf": ("erff(v)", "erf(v)"), "erfc": ("erfcf(v)", "erfc(v)"),
    "square": ("v * v", "v * v"),
    "rsqrt": ("1.0f / sqrtf(v)", "1.0 / sqrt(v)"),
    "reciprocal": ("1.0f / v", "1.0 / v"),
    # NaN stays NaN and a zero keeps its sign, as torch.sign
    "sign": ("v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v)", "v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : v)"),
}


def _extra_math(functions) -> str:
    """The :data:`_EXTRA_MATH` definitions the emitted ``functions`` call."""
    text = "".join(functions)
    lines = []
    for op, (f32, f64) in _EXTRA_MATH.items():
        if f"pm_{op}(" in text:
            params = "{0} a, {0} b" if op in _BINARY_FUNCS else "{0} v"
            lines.append(f"#ifndef PHARMSOL_RHS_MATH_{op.upper()}\n"
                         f"#define PHARMSOL_RHS_MATH_{op.upper()}\n"
                         f"__device__ __forceinline__ float pm_{op}({params.format('float')}) "
                         f"{{ return {f32}; }}\n"
                         f"__device__ __forceinline__ double pm_{op}({params.format('double')}) "
                         f"{{ return {f64}; }}\n#endif\n")
    return "".join(lines)


def _emit_function(outputs: List[Sym], name: str, args, out_name: str,
                   given=None) -> str:
    """One straight-line ``template <typename T> __device__`` function
    ``name(const T* x, ..., T t, ..., T* out_name)`` computing ``outputs``
    from the closure's arguments ``args`` (as :func:`_trace`); ``given`` maps
    the id of a node the caller computed already to the expression that
    reads it (its subgraph is not emitted)."""
    names = dict(given or {})
    leaf_names = {a for a, _ in args}

    def ref(node) -> str:
        if id(node) in names:
            return names[id(node)]
        if node.op == "const":
            return _literal(node.value)
        if node.op == "bconst":
            return "true" if node.value else "false"
        if node.op in leaf_names:
            return node.op if node.value is None else f"{node.op}[{node.value}]"
        return names[id(node)]

    def expr(node) -> str:
        a = [ref(v) for v in node.args]
        op = node.op
        if op in _ARITH:
            return f"{a[0]} {_ARITH[op]} {a[1]}"
        if op in _CMP:
            return f"{a[0]} {_CMP[op]} {a[1]}"
        if op in _BOOL_OPS:
            return f"{a[0]} {_BOOL_OPS[op]} {a[1]}"
        if op == "neg":
            return f"-{a[0]}"
        if op == "not":
            return f"!{a[0]}"
        if op == "cast":
            return f"T({a[0]})"
        if op in ("exp", "log", "sqrt", "abs", "min", "max") or op in _EXTRA_MATH:
            return f"pm_{op}({', '.join(a)})"
        if op == "where":
            return f"{a[0]} ? {a[1]} : {a[2]}"
        if op == "pow":
            e = node.args[1]
            if e.op == "const":
                # the exponents torch.pow specializes, computed the same way
                special = {2.0: f"{a[0]} * {a[0]}",
                           3.0: f"{a[0]} * {a[0]} * {a[0]}",
                           0.5: f"pm_sqrt({a[0]})",
                           -0.5: f"T(1) / pm_sqrt({a[0]})",
                           -1.0: f"T(1) / {a[0]}",
                           -2.0: f"T(1) / ({a[0]} * {a[0]})",
                           1.0: a[0]}
                if e.value in special:
                    return special[e.value]
            return f"pm_pow({a[0]}, {a[1]})"
        raise AssertionError(op)

    body = []
    for i, node in enumerate(_topo(outputs, frozenset(given or ()))):
        names[id(node)] = f"v{i}"
        ctype = "bool" if node.is_bool else "T"
        body.append(f"  const {ctype} v{i} = {expr(node)};")
    for i, o in enumerate(outputs):
        body.append(f"  {out_name}[{i}] = {ref(o)};")
    params = ", ".join(f"T {a}" if size is None else f"const T* {a}"
                       for a, size in args)
    unused = " ".join(f"(void){a};" for a, _ in args)
    return (
        "template <typename T>\n"
        f"__device__ __forceinline__ void {name}({params}, T* {out_name}) {{\n"
        f"  {unused}\n"
        + "\n".join(body) + "\n}\n"
    )


# The covariate-only terms: the subexpressions of an RHS that read only
# parameters, constants and covariate values (a covariate read, cov_a[i] or
# cov_a[i] + cov_b[i] * t, counts as a value), at most _MAX_PRE of them, held
# in registers across a march call. A term enters when it costs more than one
# operation, priced by _TERM_COST (a software routine in float64) and 1
# otherwise.
_MAX_PRE = 8
_TERM_COST = {"pow": 16, "exp": 16, "log": 16, "div": 8, "sqrt": 8, "sin": 16, "cos": 16,
              "tan": 16, "log10": 16, "log2": 16, "tanh": 16, "sinh": 16, "cosh": 16,
              "asin": 16, "acos": 16, "atan": 16, "atan2": 16, "sigmoid": 16, "log1p": 16,
              "expm1": 16, "erf": 16, "erfc": 16, "rsqrt": 8, "reciprocal": 8}
_INVARIANT_LEAVES = ("p", "const", "bconst", "cov_a", "cov_b")


def _is_cov_read(node) -> bool:
    """An affine covariate read, cov_a[i] + cov_b[i] * (a time), as
    :class:`_SymCov` traces it."""
    return (node.op == "add" and node.args[0].op == "cov_a" and node.args[1].op == "mul"
            and node.args[1].args[0].op == "cov_b")


def covariate_only_terms(outputs: List[Sym]) -> List[Sym]:
    """The smallest set of subexpressions of ``outputs`` that read only
    parameters, constants and covariate values and feed the rest of the
    RHS (or are outputs), each costing more than one operation; at most
    ``_MAX_PRE``, the costliest kept, in evaluation order. With every
    covariate's slope zero within a march call they are constant over it:
    ``rhs_pre`` computes them once, ``rhs_body`` reads them."""
    order = _topo(outputs)
    inv = {}

    def invariant(node) -> bool:
        return inv[id(node)] if node.args else node.op in _INVARIANT_LEAVES

    for node in order:
        inv[id(node)] = _is_cov_read(node) or all(invariant(a) for a in node.args)
    feeds_rest = {id(o) for o in outputs}
    for node in order:
        if not inv[id(node)]:
            feeds_rest.update(id(a) for a in node.args)
    terms = []
    for node in order:
        if inv[id(node)] and not node.is_bool and id(node) in feeds_rest:
            cost = sum(_TERM_COST.get(n.op, 1) for n in _topo([node]))
            if cost > 1:
                terms.append((cost, node))
    keep = {id(n) for _, n in sorted(terms, key=lambda cn: -cn[0])[:_MAX_PRE]}
    return [n for _, n in terms if id(n) in keep]


def _header(what: str, n_states, n_params, ninput, functions, covs,
            jacobian: bool = False, n_pre: int = 0) -> str:
    names, modes = covs
    listed = ", ".join(f"{n} ({m})" for n, m in zip(names, modes)) or "none"
    cov_lines = (f"// covariates, in cov_a/cov_b order: {listed}\n"
                 f"#define PHARMSOL_RHS_NCOV {len(names)}\n")
    if jacobian:
        cov_lines += "#define PHARMSOL_RHS_HAS_JVP 1\n"
    if n_pre:
        cov_lines += (f"// rhs_pre: {n_pre} covariate-only terms, held in registers across a "
                      f"march call\n#define PHARMSOL_RHS_NPRE {n_pre}\n")
    return (
        "// Generated by pharmsol_tpu_torch/ops/rhs_codegen.py from a model's\n"
        f"// torch {what}: do not edit.\n"
        "#pragma once\n"
        f"#define PHARMSOL_RHS_NSTATES {n_states}\n"
        f"#define PHARMSOL_RHS_NPARAMS {n_params}\n"
        f"#define PHARMSOL_RHS_NINPUT {ninput}\n"
        + cov_lines + _MATH_PRELUDE + _extra_math(functions) + "".join(functions)
    )


def _check_against_closure(fn, outputs, args, n_out: int, what: str, covs,
                           style: str = "lanes"):
    """The traced graph and the closure, on the same random float64 lane
    (and random covariate coefficients); a stacked closure on two lanes
    under ``vmap``, as the twins call it."""
    rng = np.random.RandomState(7)
    names, modes = covs
    lanes = () if style == "lanes" else (2,)
    leaves = {name: (torch.full(lanes, 1.37, dtype=torch.float64) if size is None
                     else torch.as_tensor(rng.uniform(0.5, 2.0, lanes + (size,))))
              for name, size in args}
    a = torch.as_tensor(rng.uniform(0.5, 2.0, lanes + (len(names),)))
    b = torch.as_tensor(rng.uniform(-0.2, 0.2, lanes + (len(names),)))
    cov_leaves = {"cov_a": a, "cov_b": b}

    def closure(*vals):
        *arg_vals, ca, cb = vals
        shim = LaneCov({n: ca[..., i] if m == "const" else (ca[..., i], cb[..., i])
                        for i, (n, m) in enumerate(zip(names, modes))})
        out = fn(*arg_vals, shim)
        if not isinstance(out, torch.Tensor):
            out = torch.stack([torch.as_tensor(c, dtype=torch.float64) for c in out])
        return out.to(torch.float64).reshape(n_out)

    if style == "lanes":
        want = closure(*leaves.values(), a, b)
    else:
        want = torch.func.vmap(closure)(*leaves.values(), a, b)
    got = evaluate(outputs, **leaves, **cov_leaves)
    # NaN where both are NaN (asin of a lane out of its domain, say)
    scale = float(torch.nan_to_num(want.abs(), nan=0.0).max()) if want.numel() else 0.0
    ok = torch.isclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    if not bool((ok | (torch.isnan(got) & torch.isnan(want))).all()):
        raise PharmsolError(
            f"the traced {what} disagrees with the closure evaluated on tensors "
            "(does it branch on isinstance or on tensor shapes?)"
        )


def _traced(fn, args, n_out: int, what: str, family: str, covs,
            stacked: bool = True) -> tuple:
    """Trace and check one closure in the first style that takes it, lanes
    and then (where ``stacked``) value vectors, as the JAX plan tries
    ``make_lane_rhs`` and then ``make_stacked_rhs``: ``(outputs, style)``;
    PharmsolError with the reason when the generator cannot express it."""

    def attempt(vectors: bool):
        return _trace(fn, args, n_out, f"the {what}", covs, vectors=vectors)

    try:
        try:
            outputs, style = attempt(False), "lanes"
        except _VectorStyle as e:
            if not stacked:
                raise PharmsolError(
                    f"{e}: vector-style code, which the fused {family} plan does not "
                    "take (it traces lanes only, as the JAX package's): write each "
                    "component and return a list or torch.stack([...])") from None
            outputs, style = attempt(True), "stacked"
        except PharmsolError:
            raise
        except Exception:
            if not stacked:
                raise
            outputs, style = attempt(True), "stacked"
        _check_against_closure(fn, outputs, args, n_out, what, covs, style)
    except PharmsolError as e:
        raise PharmsolError(f"the {family} {what} cannot run in the CUDA kernel: {e}") from None
    except Exception as e:
        raise PharmsolError(
            f"the {family} {what} cannot run in the CUDA kernel: tracing it "
            f"failed ({type(e).__name__}: {e})"
        ) from None
    return outputs, style


def _covariates(cov_names, cov_modes):
    """``(names, modes)`` checked: one of :data:`COV_MODES` per covariate
    (default all ``const``)."""
    cov_names = tuple(str(n) for n in cov_names)
    cov_modes = tuple(cov_modes) if cov_modes is not None else ("const",) * len(cov_names)
    if len(cov_modes) != len(cov_names) or any(m not in COV_MODES for m in cov_modes):
        raise ValueError(f"cov_modes {cov_modes} must give one of {COV_MODES} per "
                         f"covariate {cov_names}")
    return cov_names, cov_modes


def generate_rhs(diffeq: Callable, n_states: int, n_params: int,
                 ninput: int, cov_names=(), cov_modes=None,
                 jacobian: bool = False) -> GeneratedRhs:
    """Trace ``diffeq`` and emit its CUDA header; raises PharmsolError with
    the reason when the closure uses something the generator cannot
    express. ``cov_names`` are the covariates the closure may read, in the
    kernel's order, ``cov_modes`` their modes (``const`` or ``affine``;
    default all ``const``). ``jacobian`` adds ``rhs_jvp`` (the state
    Jacobian times a vector, by symbolic forward mode) to the header. The
    result's ``style`` says how the closure traced: ``"lanes"``, or
    ``"stacked"`` where it fails on lists (the header does not say: a
    vector-style spelling of a list-style RHS has its header and key)."""
    ninput = max(int(ninput), 1)
    covs = cov_names, cov_modes = _covariates(cov_names, cov_modes)
    args = _sizes(_ODE_ARGS, n_states, n_params, ninput)
    outputs, style = _traced(diffeq, args, n_states, "RHS", "ODE", covs)
    c_args = args + (("cov_a", len(cov_names)), ("cov_b", len(cov_names)))
    functions = [_emit_function(outputs, "rhs", c_args, "dx")]
    pre = []
    if jacobian:
        try:
            jv = tangents(outputs)
        except PharmsolError as e:
            raise PharmsolError(
                f"the ODE RHS has no Jacobian in the CUDA kernel: {e}") from None
        functions.append(_emit_function(jv, "rhs_jvp", c_args + (("v", n_states),), "jv"))
    else:
        # the explicit tier's split (the tiers with rhs_jvp keep rhs alone)
        pre = covariate_only_terms(outputs)
    if pre:
        pre_args = (("p", n_params), ("t", None)) + c_args[-2:]
        functions.append(_emit_function(pre, "rhs_pre", pre_args, "pre"))
        functions.append(_emit_function(outputs, "rhs_body", c_args + (("pre", len(pre)),), "dx",
                                        given={id(n): f"pre[{i}]" for i, n in enumerate(pre)}))
    source = _header("RHS closure", n_states, n_params, ninput, functions, covs,
                     jacobian, len(pre))
    key = hashlib.sha256(source.encode()).hexdigest()[:16]
    return GeneratedRhs(diffeq, int(n_states), int(n_params), ninput, source, key,
                        cov_names, cov_modes, bool(jacobian), len(pre), style)


def generate_sde(drift: Callable, diffusion: Callable, n_states: int,
                 n_params: int, ninput: int, cov_names=(), cov_modes=None) -> GeneratedSde:
    """Trace an SDE's ``drift(x, p, t, rateiv, cov)`` and ``diffusion(p, t,
    cov)`` and emit both into one CUDA header, as ``drift<T>(x, p, t, rateiv,
    cov_a, cov_b, dx)`` and ``diffusion<T>(p, t, cov_a, cov_b, g)``, with the
    covariates ``cov_names`` in modes ``cov_modes`` as :func:`generate_rhs`.
    A diffusion of constants traces to literal outputs. The components that
    trace to a literal zero are ``zero_diffusion``, and the header marks the
    others as ``PHARMSOL_SDE_NOISY`` (an initializer of one bool per state):
    the kernel draws no noise for a component it marks quiet. A component
    that only evaluates to zero (a parameter or a covariate that may be 0)
    stays noisy. Raises PharmsolError with the reason when either closure
    uses something the generator cannot express (an unknown covariate among
    it); vector-style code is refused, as the JAX SDE plan refuses it, so
    both closures are called with lists of lanes."""
    ninput = max(int(ninput), 1)
    covs = cov_names, cov_modes = _covariates(cov_names, cov_modes)
    cov_args = (("cov_a", len(cov_names)), ("cov_b", len(cov_names)))
    d_args = _sizes(_DRIFT_ARGS, n_states, n_params, ninput)
    g_args = _sizes(_DIFFUSION_ARGS, n_states, n_params, ninput)
    d_out, _ = _traced(drift, d_args, n_states, "drift", "SDE", covs, stacked=False)
    g_out, _ = _traced(diffusion, g_args, n_states, "diffusion", "SDE", covs, stacked=False)
    zero = frozenset(i for i, g in enumerate(g_out) if g.op == "const" and g.value == 0.0)
    noisy = ", ".join("false" if i in zero else "true" for i in range(n_states))
    source = _header("SDE drift and diffusion closures", n_states, n_params, ninput,
                     [f"#define PHARMSOL_SDE_NOISY {{{noisy}}}\n",
                      _emit_function(d_out, "drift", d_args + cov_args, "dx"),
                      _emit_function(g_out, "diffusion", g_args + cov_args, "g")], covs)
    key = hashlib.sha256(source.encode()).hexdigest()[:16]
    return GeneratedSde(drift, diffusion, int(n_states), int(n_params), ninput,
                        source, key, cov_names, cov_modes, zero)
