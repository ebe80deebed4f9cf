"""A numpy-shaped array namespace over torch, for EvalCtx(xp=...).

The evaluator (expression/vec.py) is written once against an array
namespace: numpy on the host, and in tidb_tpu jax.numpy on the device.
TorchNS is the port's device namespace: the functions vec.py calls as
`xp.<name>`, with numpy's argument forms (numpy dtypes, python
scalars, numpy tables) and numpy's result dtypes, producing tensors on
one torch device.

numpy and torch differ where it matters here:
- torch promotes int64 with a python float (and true division of ints)
  to its default float32; numpy gives float64. Every function below
  that can produce floats from ints names float64.
- numpy's searchsorted side="left"/"right" is torch's right=False/True.
- uint64 has few torch ops (fewer on CUDA); the evaluator's uint64 bit
  tricks are not on the port's device path (ops outside TORCH_OPS run
  on the host), and asking for uint64 here raises.
- tensors have no `.astype`; the evaluator's `.astype` sites belong to
  ops outside TORCH_OPS (casts, string and vector functions, bit
  tricks), which a later slice ports with the op.

TORCH_OPS lists the evaluator ops whose device forms were checked
against the numpy EvalCtx (tests/test_torch_expression.py); a fragment
whose expressions use any other op is declined before dispatch and
runs on the host."""
from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

# evaluator ops (vec.py @op names) whose torch forms are checked
# against the numpy EvalCtx; see the module docstring
TORCH_OPS = frozenset({
    "+", "-", "*", "/", "div", "%", "mod", "unary-",
    "=", "!=", "<", "<=", ">", ">=",
    "and", "or", "xor", "not", "isnull", "isnotnull",
    "year", "month", "day", "dayofmonth",
    "date_add", "date_sub", "adddate", "subdate",
    # string and conditional ops: dict-coded strings evaluate as a host
    # table over the dictionary gathered by code (like, substring, IN of
    # strings), numbers as compares (IN), CASE as nested wheres
    "in", "case_when", "like", "substring",
})


def torch_dtype(dtype):
    """numpy dtype / python type / torch dtype -> torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bool:
        return torch.bool
    if dtype is int:
        return torch.int64
    if dtype is float:
        return torch.float64
    nd = np.dtype(dtype)
    td = _NP_TO_TORCH.get(nd)
    if td is None:
        raise TypeError(
            f"dtype {nd} has no device form in tidb_tpu_torch "
            "(uint64 and object columns run on the host)")
    return td


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class TorchNS:
    """numpy-like namespace whose arrays are tensors on `device`."""

    bool_ = np.bool_
    int32 = np.int32
    int64 = np.int64
    float64 = np.float64
    inf = np.inf
    nan = np.nan
    pi = np.pi

    def __init__(self, device):
        self.device = torch.device(device)

    def __repr__(self):
        return f"TorchNS({self.device})"

    @property
    def uint64(self):
        raise TypeError("uint64 arithmetic is not on tidb_tpu_torch's "
                        "device path")

    # ---- construction ------------------------------------------------
    def asarray(self, x, dtype=None):
        td = torch_dtype(dtype)
        if isinstance(x, torch.Tensor):
            t = x
            if t.device != self.device:
                t = t.to(self.device)
            return t if td is None or t.dtype == td else t.to(td)
        # a scalar becomes a fill on the device (its value rides as a
        # kernel argument), an array a copy from pinned host memory: on
        # the card neither waits, where torch.tensor(x, device=...) and
        # a copy from pageable memory both block until the card is done
        if isinstance(x, np.generic):
            if x.dtype == object:
                raise TypeError("object arrays have no device form")
            return torch.full((), x.item(), dtype=td or torch_dtype(x.dtype),
                              device=self.device)
        if isinstance(x, np.ndarray):
            if x.dtype == object:
                raise TypeError("object arrays have no device form")
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            return t if td is None or t.dtype == td else t.to(td)
        if isinstance(x, bool):
            return torch.full((), x, dtype=td or torch.bool,
                              device=self.device)
        if isinstance(x, int):
            return torch.full((), x, dtype=td or torch.int64,
                              device=self.device)
        if isinstance(x, float):
            return torch.full((), x, dtype=td or torch.float64,
                              device=self.device)
        return self.asarray(np.asarray(x), dtype)

    def _fill_dtype(self, v, dtype):
        td = torch_dtype(dtype)
        if td is not None:
            return td
        if isinstance(v, torch.Tensor):
            return v.dtype
        if isinstance(v, (bool, np.bool_)):
            return torch.bool
        if isinstance(v, (int, np.integer)):
            return torch.int64
        return torch.float64

    def zeros(self, n, dtype=None):
        return torch.zeros(n, dtype=torch_dtype(dtype) or torch.float64,
                           device=self.device)

    def ones(self, n, dtype=None):
        return torch.ones(n, dtype=torch_dtype(dtype) or torch.float64,
                          device=self.device)

    def full(self, n, v, dtype=None):
        td = self._fill_dtype(v, dtype)
        if isinstance(v, torch.Tensor):
            return v.to(td).expand(n).clone()
        return torch.full((n,), v, dtype=td, device=self.device)

    def arange(self, *args, dtype=None):
        return torch.arange(*args, dtype=torch_dtype(dtype) or torch.int64,
                            device=self.device)

    # ---- elementwise -------------------------------------------------
    def _pair(self, a, b):
        """Operands -> tensors with numpy's promotion (python floats and
        int/float mixes give float64, never torch's float32)."""
        ta = isinstance(a, torch.Tensor)
        tb = isinstance(b, torch.Tensor)
        if not ta:
            a = self.asarray(a)
        if not tb:
            b = self.asarray(b)
        if a.dtype != b.dtype:
            if _is_float(a) or _is_float(b):
                dt = torch.float64 if (a.dtype == torch.float64 or
                                       b.dtype == torch.float64 or
                                       not ta or not tb) \
                    else torch.promote_types(a.dtype, b.dtype)
            elif a.dtype == torch.bool or b.dtype == torch.bool:
                dt = b.dtype if a.dtype == torch.bool else a.dtype
            else:
                dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return a, b

    def where(self, cond, a, b):
        cond = self.asarray(cond, dtype=bool)
        a, b = self._pair(a, b)
        return torch.where(cond, a, b)

    def minimum(self, a, b):
        a, b = self._pair(a, b)
        return torch.minimum(a, b)

    def maximum(self, a, b):
        a, b = self._pair(a, b)
        return torch.maximum(a, b)

    def clip(self, a, lo, hi):
        a = self.asarray(a)
        return torch.clamp(a, lo, hi)

    def abs(self, a):
        return torch.abs(self.asarray(a))

    def sign(self, a):
        return torch.sign(self.asarray(a))

    def _f(self, a):
        a = self.asarray(a)
        return a if _is_float(a) else a.to(torch.float64)

    def floor(self, a):
        a = self.asarray(a)
        return torch.floor(a) if _is_float(a) else a

    def ceil(self, a):
        a = self.asarray(a)
        return torch.ceil(a) if _is_float(a) else a

    def trunc(self, a):
        a = self.asarray(a)
        return torch.trunc(a) if _is_float(a) else a

    def round(self, a, decimals=0):
        a = self.asarray(a)
        if not _is_float(a):
            return a
        return torch.round(a, decimals=decimals)

    def sqrt(self, a):
        return torch.sqrt(self._f(a))

    def exp(self, a):
        return torch.exp(self._f(a))

    def log(self, a):
        return torch.log(self._f(a))

    def sin(self, a):
        return torch.sin(self._f(a))

    def cos(self, a):
        return torch.cos(self._f(a))

    def tan(self, a):
        return torch.tan(self._f(a))

    def arcsin(self, a):
        return torch.asin(self._f(a))

    def arccos(self, a):
        return torch.acos(self._f(a))

    def arctan(self, a):
        return torch.atan(self._f(a))

    def arctan2(self, a, b):
        return torch.atan2(self._f(a), self._f(b))

    def degrees(self, a):
        return torch.rad2deg(self._f(a))

    def radians(self, a):
        return torch.deg2rad(self._f(a))

    def isnan(self, a):
        return torch.isnan(self._f(a))

    # ---- lookups -----------------------------------------------------
    def isin(self, a, table):
        return torch.isin(self.asarray(a), self.asarray(table))

    def searchsorted(self, sorted_seq, v, side="left"):
        s = self.asarray(sorted_seq)
        v = self.asarray(v)
        if v.dtype != s.dtype:
            s, v = self._pair(s, v)
        return torch.searchsorted(s, v, right=(side == "right"))

    def cumsum(self, a, dtype=None):
        return torch.cumsum(self.asarray(a), 0,
                            dtype=torch_dtype(dtype) or None)


def ops_of(expr, out=None) -> set:
    """The evaluator op names an expression tree uses."""
    from .expr import ScalarFunc
    if out is None:
        out = set()
    if isinstance(expr, ScalarFunc):
        out.add(expr.op)
        for a in expr.args:
            ops_of(a, out)
    return out
