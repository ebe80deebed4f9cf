"""A numpy-shaped array namespace over torch, for EvalCtx(xp=...), and
the rule that says which expressions run on the device.

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
- uint64 has few torch ops (fewer on CUDA). The evaluator's unsigned
  values are int64 bit patterns on both backends (storage keeps BIGINT
  UNSIGNED so), and its uint64 bit tricks (BIT_COUNT's popcount) run
  here on those int64 bits: xp.uint64 is the marker _UINT64_BITS, a
  numpy uint64 array uploads as its int64 view, and bitwise ops are
  bit-identical.
- shifts by 64 or more, or by a negative count, are undefined in C;
  left_shift / right_shift give numpy's (and XLA's) answers: 0, or the
  sign fill for a right shift.
- tensors have no `.astype`; the evaluator calls xp.astype on them.

Every evaluator op that the reference lets into a device fragment
(vec._REGISTRY less _HOST_ONLY, as vec.is_device_safe says) has its
device form here, predict() too. device_form(expr) is the rule a
fragment passes before dispatch: every op has a device form, and no op
meets a shape whose device form reads values on the host (a number
made into text row by row, several dictionary columns concatenated,
QUOTE over a value that may be NULL, UNIX_TIMESTAMP of text). Those shapes are exactly the ones
whose trace fails in the reference, which then runs the fragment on the
host; here they are declined before dispatch, with the reason
"host-bound shape: <op> of <argument>", and run on the host twin."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..chunk.device import upload

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    # unsigned 64-bit values ride as their int64 bit patterns
    np.dtype(np.uint64): torch.int64,
}

class _UInt64Bits:
    """xp.uint64 of TorchNS: unsigned 64-bit values carried as their
    int64 bit patterns. Called on a number it gives the python int with
    the same 64 bits; as a dtype it is torch.int64."""

    def __call__(self, v):
        return ((int(v) + (1 << 63)) % (1 << 64)) - (1 << 63)

    def __repr__(self):
        return "uint64 (as int64 bits)"


_UINT64_BITS = _UInt64Bits()


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
    if dtype is _UINT64_BITS:
        return torch.int64
    nd = np.dtype(dtype)
    td = _NP_TO_TORCH.get(nd)
    if td is None:
        raise TypeError(
            f"dtype {nd} has no device form in tidb_tpu_torch "
            "(object columns run on the host)")
    return td


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class TorchNS:
    """numpy-like namespace whose arrays are tensors on `device`."""

    bool_ = np.bool_
    int32 = np.int32
    int64 = np.int64
    float32 = np.float32
    float64 = np.float64
    inf = np.inf
    nan = np.nan
    pi = np.pi

    def __init__(self, device):
        self.device = torch.device(device)

    def __repr__(self):
        return f"TorchNS({self.device})"

    uint64 = _UINT64_BITS

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
            v = x.item()
            if x.dtype == np.uint64:
                v = _UINT64_BITS(v)
            return torch.full((), v, dtype=td or torch_dtype(x.dtype),
                              device=self.device)
        if isinstance(x, np.ndarray):
            if x.dtype == object:
                raise TypeError("object arrays have no device form")
            if x.dtype == np.uint64:
                x = x.view(np.int64)
            t = upload(x, self.device)
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
        a = self.asarray(a)
        s = torch.sign(a)
        # numpy's sign of NaN is NaN (torch's is 0)
        return torch.where(torch.isnan(a), a, s) if _is_float(a) else s

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

    def log2(self, a):
        return torch.log2(self._f(a))

    def log10(self, a):
        return torch.log10(self._f(a))

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

    # ---- dtypes and bits ---------------------------------------------
    def astype(self, a, dtype):
        """numpy's a.astype(dtype) (tensors have no .astype)."""
        return self.asarray(a, dtype=dtype)

    def left_shift(self, a, b):
        """numpy's left_shift of int64 values: 0 where the count is
        negative or 64 and more (C and CUDA leave those undefined)."""
        a, b = self._pair(a, b)
        ok = (b >= 0) & (b < 64)
        return torch.where(ok, a << torch.where(ok, b, 0),
                           torch.zeros((), dtype=a.dtype,
                                       device=self.device))

    def right_shift(self, a, b):
        """numpy's arithmetic right_shift of int64 values: the sign
        fill (0 or -1) where the count is negative or 64 and more."""
        a, b = self._pair(a, b)
        ok = (b >= 0) & (b < 64)
        return torch.where(ok, a >> torch.where(ok, b, 0), a >> 63)

    # ---- lookups -----------------------------------------------------
    def isin(self, a, table):
        return torch.isin(self.asarray(a), self.asarray(table))

    def searchsorted(self, sorted_seq, v, side="left"):
        s = self.asarray(sorted_seq)
        v = self.asarray(v)
        if v.dtype != s.dtype:
            s, v = self._pair(s, v)
        return torch.searchsorted(s, v, right=(side == "right"))

    def stack(self, arrs, axis=0):
        return torch.stack([self.asarray(a) for a in arrs], dim=axis)

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


# ---- the device rule ------------------------------------------------------

# ops whose device form makes text of a number row by row on the host
# (vec._to_str_val, _int_to_str_col, cast_char's loop): a number held
# on the device cannot reach them
_TEXT_OF_NUMBER = {"cast_char": (0,), "bin": (0,), "oct": (0,),
                   "format": (0,), "json_extract": (0,), "quote": (0,)}
# ops that, over python constants alone, stay python values (their
# bodies run python on constants); every other op makes a device array
_PY_ON_CONSTANTS = {"pi", "char", "space", "elt", "concat", "cast_char",
                    "bin", "oct", "format", "hex", "conv"}
# ops whose NULL mask never carries a NULL of an argument, and ops whose
# mask is exactly their arguments' (every other op may make NULLs of its
# own: x / 0, SQRT of a negative, NULLIF, an unparsable date ...)
_NEVER_NULL = {"isnull", "isnotnull", "<=>", "istrue", "isfalse", "field"}
_NULL_OF_ARGS = {"+", "-", "*", "unary-", "abs", "=", "!=", "<", "<=", ">",
                 ">=", "lower", "lcase", "upper", "ucase", "concat", "char",
                 "space", "pi"}


def _ANY_NULL(_idx):
    return True


class _HostBound(Exception):
    pass


class Decline(NamedTuple):
    """Why a fragment does not run on the device: kind "unsafe" (an op
    or a decimal with no device form: vec.is_device_safe is false) or
    "host_bound" (every op has a device form, but this shape's reads
    values on the host, and the reference's trace of it fails)."""
    kind: str
    reason: str


def _kind_of(ft):
    from ..types.field_type import TypeClass
    tc = ft.tclass if ft is not None else None
    return {TypeClass.INT: "int", TypeClass.UINT: "int",
            TypeClass.FLOAT: "double", TypeClass.DECIMAL: "decimal",
            TypeClass.DATE: "date", TypeClass.DATETIME: "datetime",
            TypeClass.TIMESTAMP: "datetime"}.get(tc, "number")


def _is_text(ft):
    from ..types.field_type import TypeClass
    return ft is not None and ft.tclass in (
        TypeClass.STRING, TypeClass.JSON, TypeClass.ENUM, TypeClass.SET)


def _form(expr, nullable):
    """-> (form, may_null): form is "const" (a python value: number,
    text or NULL), "dict" (dictionary codes on the device) or "arr" (a
    number on the device); may_null says the value may carry a NULL
    mask. Raises _HostBound for a shape whose device form reads the
    host. `expr` is device-safe (vec.is_device_safe)."""
    from .expr import Column, Constant
    if isinstance(expr, Column):
        return ("dict" if _is_text(expr.ft) else "arr",
                bool(nullable(expr.idx)))
    if isinstance(expr, Constant):
        return "const", expr.value.is_null
    op = expr.op
    forms = [_form(a, nullable) for a in expr.args]
    kinds = [f for f, _n in forms]
    may_null = any(n for _f, n in forms)

    def bound(i):
        raise _HostBound(f"host-bound shape: {op} of "
                         f"{_kind_of(expr.args[i].ft)}")
    text_args = _TEXT_OF_NUMBER.get(op, ())
    if op == "concat":
        text_args = range(len(forms))
    elif op in ("hex", "conv") and not _is_text(expr.args[0].ft):
        text_args = (0,)
    for i in text_args:
        if kinds[i] == "arr":
            bound(i)
    if op == "concat" and not any(
            f == "const" and n for f, n in forms) and \
            sum(k != "const" for k in kinds) > 1:
        raise _HostBound("host-bound shape: concat of several columns")
    if op == "quote" and may_null:
        raise _HostBound("host-bound shape: quote of a nullable value")
    if op == "unix_timestamp" and _is_text(expr.args[0].ft):
        raise _HostBound("host-bound shape: unix_timestamp of text")
    if op in _NEVER_NULL:
        may_null = False
    elif op not in _NULL_OF_ARGS:
        may_null = True
    if all(k == "const" for k in kinds) and (
            op in _PY_ON_CONSTANTS or
            (kinds and any(_is_text(a.ft) for a in expr.args))):
        return "const", may_null
    return ("dict" if _is_text(expr.ft) else "arr"), may_null


def device_form(expr, nullable=None):
    """The device rule: None when the evaluator's device form of `expr`
    runs on the device (every op device-safe, no host-bound shape),
    else the Decline that says why it runs on the host.
    `nullable(col_idx)` says whether a column is bound with a NULL mask
    (by default every column may be)."""
    from .vec import _HOST_ONLY, _REGISTRY, is_device_safe
    if not is_device_safe(expr):
        ops = sorted(op for op in ops_of(expr)
                     if op in _HOST_ONLY or op not in _REGISTRY)
        return Decline("unsafe", "no device form: " + (
            ", ".join(ops) if ops else "a decimal above 18 digits"))
    if nullable is None or "quote" not in ops_of(expr):
        nullable = _ANY_NULL         # only QUOTE's route reads the masks
    try:
        _form(expr, nullable)
    except _HostBound as exc:
        return Decline("host_bound", str(exc))
    return None
