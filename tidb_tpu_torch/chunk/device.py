"""Host <-> device bridge: padded, masked device batches.

Every column pads to a bucketed length and carries a validity mask — the
device analog of the reference's `sel` vector + null bitmap
(pkg/util/chunk/chunk.go:35). Bucketed shapes keep the set of kernel
launch shapes (and cached fragment callables) small.

String columns are dictionary-encoded: int32 codes on device, dictionary on
host. Equality/grouping/join on codes is exact when both sides share a
dictionary (ColumnarTable guarantees per-column global dicts); ad-hoc
batches build a local dict on transfer.
"""
from __future__ import annotations

import numpy as np

import torch

from .column import Column
from ..types import FieldType, TypeClass

BUCKET_MIN = 1024


# ---- collation normal forms (reference pkg/util/collate/collate.go) ----
# Each _ci collation is a host-side fold to its normal form; all the
# device-side machinery (norm tables, fold codes, ranks) is generic over
# the fold. unicode_ci / 0900_ai_ci weights are computed from Unicode
# decomposition (NFD, combining marks stripped) + casefold, which
# reproduces MySQL's primary-weight behavior for these collations:
# accent-insensitive, case-insensitive, 'ss' == U+00DF. PAD semantics
# differ: pre-0900 collations PAD SPACE (trailing spaces ignored),
# 0900_* are NO PAD.

def _fold_general(s):
    """utf8mb4_general_ci + PAD SPACE: casefold, strip trailing
    spaces (reference pkg/util/collate general_ci collator)."""
    return s.casefold().rstrip(" ") if isinstance(s, str) else s


def _strip_marks(s):
    import unicodedata
    d = unicodedata.normalize("NFD", s)
    return "".join(ch for ch in d if not unicodedata.combining(ch))


def _fold_unicode(s):
    """utf8mb4_unicode_ci (UCA primary weights) + PAD SPACE."""
    return _strip_marks(s.casefold()).rstrip(" ") \
        if isinstance(s, str) else s


def _fold_0900_ai(s):
    """utf8mb4_0900_ai_ci: UCA 9.0 primary weights, NO PAD."""
    return _strip_marks(s.casefold()) if isinstance(s, str) else s


_ASCII_UPPER = str.maketrans(
    "abcdefghijklmnopqrstuvwxyz", "ABCDEFGHIJKLMNOPQRSTUVWXYZ")


def _fold_gbk(s):
    """gbk_chinese_ci + PAD SPACE (reference
    pkg/util/collate/gbk_chinese_ci.go): ASCII letters weigh as their
    uppercase, Chinese characters by their GBK code. The normal form
    maps each char's GBK encoding to latin-1 code units, so ordinary
    lexicographic comparison of folded strings IS the GBK byte order
    ('啊' 0xB0A1 < '文' 0xCEC4 < '中' 0xD6D0) — one fold serves
    equality, GROUP BY merging, and ORDER BY ranks. Characters outside
    GBK weigh as '?' (MySQL legacy-charset behavior)."""
    if not isinstance(s, str):
        return s
    return s.upper().rstrip(" ").encode(
        "gbk", errors="replace").decode("latin-1")


def _fold_gb18030(s):
    """gb18030_chinese_ci + PAD SPACE (reference
    pkg/util/collate/gb18030_chinese_ci.go): like gbk but over the full
    GB18030 plane (4-byte forms included, so every Unicode char has a
    weight)."""
    if not isinstance(s, str):
        return s
    return s.translate(_ASCII_UPPER).rstrip(" ").encode(
        "gb18030", errors="replace").decode("latin-1")


def _fold_pad(s):
    """PAD SPACE, case-sensitive (utf8mb4_bin-class collations: in
    MySQL 8 only *_0900_* and binary are NO PAD — trailing spaces are
    insignificant under every legacy collation, including the _bin
    ones)."""
    return s.rstrip(" ") if isinstance(s, str) else s


def _fold_gbk_bin(s):
    """gbk_bin: GBK code order + PAD SPACE, case-sensitive."""
    if not isinstance(s, str):
        return s
    return s.rstrip(" ").encode("gbk", errors="replace").decode("latin-1")


def _fold_gb18030_bin(s):
    if not isinstance(s, str):
        return s
    return s.rstrip(" ").encode(
        "gb18030", errors="replace").decode("latin-1")


_COLLATION_FOLDS = {
    "utf8mb4_general_ci": _fold_general,
    "utf8_general_ci": _fold_general,
    "latin1_general_ci": _fold_general,
    "utf8mb4_unicode_ci": _fold_unicode,
    "utf8_unicode_ci": _fold_unicode,
    "utf8mb4_unicode_520_ci": _fold_unicode,
    "utf8mb4_0900_ai_ci": _fold_0900_ai,
    "gbk_chinese_ci": _fold_gbk,
    "gb18030_chinese_ci": _fold_gb18030,
    "utf8mb4_bin": _fold_pad,
    "utf8_bin": _fold_pad,
    "latin1_bin": _fold_pad,
    "gbk_bin": _fold_gbk_bin,
    "gb18030_bin": _fold_gb18030_bin,
}


def collation_fold(coll):
    """Fold function for a _ci collation name (general_ci fallback for
    unregistered _ci collations, matching the previous behavior)."""
    return _COLLATION_FOLDS.get(str(coll).lower(), _fold_general)


def shape_bucket(n: int) -> int:
    """Round row count up to a quarter-power-of-two step (>= BUCKET_MIN).

    Pure powers of two waste up to ~2x compute as padding (a 599k-row
    table pads to 1M). Steps at {1, 1.25, 1.5, 1.75} x 2^k keep worst-case
    padding under 25% while still giving a small, stable set of shapes
    to cache fragments for (4 buckets per octave)."""
    if n <= BUCKET_MIN:
        return BUCKET_MIN
    p = 1 << max((n - 1).bit_length() - 1, 0)   # largest pow2 < n (or = n)
    for num in (4, 5, 6, 7, 8):
        cap = p * num // 4
        if cap >= n:
            return cap
    return 2 * p


class StringDict:
    """Per-column string dictionary: code <-> str, append-only."""

    __slots__ = ("values", "index", "sort_keys", "_vec_cache",
                 "_vecmat_cache",
                 "_ci_norm", "_ci_fold", "_ci_ranks", "_ci_fold_ranks",
                 "_rank_codes", "__weakref__")

    def __init__(self):
        self.values: list[str] = []
        self.index: dict[str, int] = {}
        self.sort_keys = None  # lazily computed rank array for ordered compares
        # collation-aware key tables (reference pkg/util/collate),
        # host-computed per (collation, dict version)
        self._ci_norm = {}   # coll -> (n, code -> canonical code)
        self._ci_fold = {}   # coll -> (n, fold_codes, fold_dict)
        self._ci_ranks = {}  # coll -> (n, code -> ci sort rank)
        self._ci_fold_ranks = {}  # coll -> (n, code -> folded ci rank)
        self._rank_codes = None  # ((coll, n), (code_map, sorted dict))

    def encode(self, arr: np.ndarray) -> np.ndarray:
        """Encode an object array of strings to int32 codes, extending dict.
        Unique-first: the O(n log n) dedup runs in C, the Python dict is
        touched once per DISTINCT value (bulk loads repeat values
        heavily; the all-distinct case degenerates to one dict op per
        row, same as the naive loop)."""
        idx = self.index
        vals = self.values
        try:
            uniq, inv = np.unique(np.asarray(arr, dtype=object),
                                  return_inverse=True)
        except TypeError:        # non-comparable mixed types: row loop
            codes = np.empty(len(arr), dtype=np.int32)
            for i, s in enumerate(arr):
                c = idx.get(s)
                if c is None:
                    c = len(vals)
                    idx[s] = c
                    vals.append(s)
                    self.sort_keys = None
                codes[i] = c
            return codes
        m = np.empty(len(uniq), dtype=np.int32)
        for j, s in enumerate(uniq):
            c = idx.get(s)
            if c is None:
                c = len(vals)
                idx[s] = c
                vals.append(s)
                self.sort_keys = None
            m[j] = c
        return m[inv].astype(np.int32, copy=False)

    def translate_codes(self, values: list, codes: np.ndarray) -> np.ndarray:
        """Codes minted against a FOREIGN dictionary (given as its value
        list) -> codes in THIS dictionary, extending it as needed."""
        mapping = np.array([self.encode_one(v) for v in values] or [0],
                           dtype=np.int32)
        return mapping[codes]

    def encode_one(self, s: str) -> int:
        c = self.index.get(s)
        if c is None:
            c = len(self.values)
            self.index[s] = c
            self.values.append(s)
            self.sort_keys = None
        return c

    def lookup(self, s: str) -> int:
        """Code for s, or -1 if absent (predicates against unseen constants)."""
        return self.index.get(s, -1)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        vals = self.values
        for i, c in enumerate(codes):
            out[i] = vals[c] if 0 <= c < len(vals) else None
        return out

    @staticmethod
    def ci_fold(s):
        """utf8mb4_general_ci + PAD SPACE normal form (the default _ci
        fold; parametrized collations go through collation_fold)."""
        return _fold_general(s)

    @staticmethod
    def _coll_name(coll) -> str:
        """Normalize the coll argument call sites pass: True/False
        booleans (legacy) or a collation name string."""
        if coll is True or coll is None:
            return "utf8mb4_general_ci"
        return str(coll).lower()

    def ci_norm_table(self, coll=True) -> np.ndarray:
        """code -> canonical code: the FIRST value sharing the
        collation's normal form. Grouping/DISTINCT through this table
        merges case/accent/padding variants while still decoding to an
        original representative (MySQL shows a witness row's value)."""
        cn = self._coll_name(coll)
        hit = self._ci_norm.get(cn)
        if hit is None or hit[0] != len(self.values):
            fold = collation_fold(cn)
            seen: dict = {}
            t = np.empty(max(len(self.values), 1), dtype=np.int64)
            for i, v in enumerate(self.values):
                t[i] = seen.setdefault(fold(v), i)
            t = t[:len(self.values)] if self.values else t
            self._ci_norm[cn] = (len(self.values), t)
        return self._ci_norm[cn][1]

    def ci_fold_codes(self, coll=True):
        """-> (codes, fold_dict): every value re-encoded by its normal
        form into a dict OF normal forms — join keys translated by
        VALUE then match across sides regardless of case/accents/
        padding (per the collation's rules)."""
        cn = self._coll_name(coll)
        hit = self._ci_fold.get(cn)
        if hit is None or hit[0] != len(self.values):
            fold = collation_fold(cn)
            fd = StringDict()
            codes = np.array([fd.encode_one(fold(v))
                              for v in self.values] or [0],
                             dtype=np.int64)
            self._ci_fold[cn] = (len(self.values), codes, fd)
        hit = self._ci_fold[cn]
        return hit[1], hit[2]

    def ci_ranks(self, coll=True) -> np.ndarray:
        """rank[code] under the collation's ordering: sorted by normal
        form, original bytes as deterministic tiebreak."""
        cn = self._coll_name(coll)
        hit = self._ci_ranks.get(cn)
        if hit is None or hit[0] != len(self.values):
            fold = collation_fold(cn)
            keyed = sorted(range(len(self.values)),
                           key=lambda i: (fold(self.values[i])
                                          if self.values[i] is not None
                                          else "",
                                          self.values[i] or ""))
            ranks = np.empty(max(len(self.values), 1), dtype=np.int64)
            for r, i in enumerate(keyed):
                ranks[i] = r
            ranks = ranks[:len(self.values)] if self.values else ranks
            self._ci_ranks[cn] = (len(self.values), ranks)
        return self._ci_ranks[cn][1]

    def ci_fold_ranks(self, coll=True) -> np.ndarray:
        """rank[code] under collation EQUALITY + order: values sharing
        the normal form get the SAME rank (MySQL: 'aa' = 'AA' — peers
        in window frames, equal sort keys), ranks ascend in collation
        order. ci_ranks() keeps a byte tiebreak and is for ORDER-only
        uses (min/max code remap)."""
        cn = self._coll_name(coll)
        hit = self._ci_fold_ranks.get(cn)
        if hit is None or hit[0] != len(self.values):
            fold = collation_fold(cn)
            folded = [fold(v) if v is not None else ""
                      for v in self.values]
            pos = {f: r for r, f in enumerate(sorted(set(folded)))}
            ranks = np.array([pos[f] for f in folded] or [0],
                             dtype=np.int64)
            self._ci_fold_ranks[cn] = (len(self.values), ranks)
        return self._ci_fold_ranks[cn][1]

    def rank_codes(self, ci=False):
        """-> (code_map, rank_ordered_dict): values re-encoded into a
        dict whose CODE ORDER equals the collation sort order, so
        numeric MIN/MAX over the mapped codes is string MIN/MAX and the
        result decodes through the new dict. Cached per dict version.
        `ci` is False (binary order) or a collation truthy/name."""
        cn = False if not ci else self._coll_name(ci)
        key = (cn, len(self.values))
        hit = self._rank_codes
        if hit is not None and hit[0] == key:
            return hit[1]
        ranks = self.ci_ranks(cn) if cn else self.ranks()
        sorted_dict = StringDict()
        order = np.argsort(ranks[:len(self.values)]) if self.values \
            else np.array([], dtype=np.int64)
        for i in order.tolist():
            sorted_dict.encode_one(self.values[i])
        code_map = np.asarray(ranks[:len(self.values)]
                              if self.values else [0], dtype=np.int64)
        # keep only the LATEST version (same policy as the sibling
        # _ci_* caches): stale per-length entries would leak O(n) each
        self._rank_codes = (key, (code_map, sorted_dict))
        return self._rank_codes[1]

    def ranks(self) -> np.ndarray:
        """rank[code] = position in sorted order — makes <,>,ORDER BY on
        dict codes a gather + int compare (collation sort keys precomputed
        on host; reference pkg/util/collate)."""
        if self.sort_keys is None or len(self.sort_keys) != len(self.values):
            # a None can be dict-encoded (e.g. a NULL branch of a UNION
            # merged into a shared dict); it doesn't compare against str,
            # and its rank never matters — readers order NULL rows via
            # the null mask — so sort it as the empty string
            vals = np.array([v if v is not None else "" for v in
                             self.values], dtype=object)
            order = np.argsort(vals, kind="stable")
            ranks = np.empty(len(self.values), dtype=np.int64)
            ranks[order] = np.arange(len(self.values))
            self.sort_keys = ranks
        return self.sort_keys


class DeviceCol:
    __slots__ = ("data", "nulls", "ft", "dict")

    def __init__(self, data, nulls, ft: FieldType, sdict: StringDict | None = None):
        self.data = data    # tensor on the batch's device, padded
        self.nulls = nulls  # bool tensor or None
        self.ft = ft
        self.dict = sdict


class DeviceBatch:
    """A set of device columns + validity mask, all padded to `cap` rows."""

    __slots__ = ("cols", "valid", "n", "cap")

    def __init__(self, cols: dict, valid, n: int, cap: int):
        self.cols = cols    # name/index -> DeviceCol
        self.valid = valid  # bool tensor [cap]; True for real rows
        self.n = n          # real row count before padding
        self.cap = cap


def _pad(a: np.ndarray, cap: int, fill=0):
    if len(a) == cap:
        return a
    pad_width = cap - len(a)
    return np.concatenate([a, np.full(pad_width, fill, dtype=a.dtype)])


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device`, keeping numpy's dtype (int64 stays
    int64, float64 stays float64, bool stays bool)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device` with numpy's dtype; on the card a
    non-blocking copy from pinned host memory, which does not wait on
    the card as a copy from pageable memory does."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def lower_column(col: Column, cap: int, sdict: StringDict | None = None,
                 device="cpu"):
    """Column -> DeviceCol on `device`, padded to cap (strings as
    int32 dict codes; object columns as float64)."""
    ft = col.ft
    if ft.tclass in (TypeClass.STRING, TypeClass.JSON):
        d = sdict or StringDict()
        codes = d.encode(col.data.astype(object))
        data = to_tensor(_pad(codes, cap), device)
        nulls = None
        if col.nulls is not None:
            nulls = to_tensor(_pad(col.nulls, cap, fill=True), device)
        return DeviceCol(data, nulls, ft, d)
    data_np = col.data
    if data_np.dtype == object:
        data_np = data_np.astype(np.float64)
    data = to_tensor(_pad(data_np, cap), device)
    nulls = None
    if col.nulls is not None:
        nulls = to_tensor(_pad(col.nulls, cap, fill=True), device)
    return DeviceCol(data, nulls, ft)


def to_device_batch(chunk, names: list | None = None,
                    dicts: dict | None = None, device="cpu") -> DeviceBatch:
    """Lower a host Chunk to a DeviceBatch on `device` with bucketed
    padding."""
    n = len(chunk)
    cap = shape_bucket(n)
    cols = {}
    for i, col in enumerate(chunk.columns):
        key = names[i] if names else i
        sdict = dicts.get(key) if dicts else None
        cols[key] = lower_column(col, cap, sdict, device)
    valid = to_tensor(_pad(np.ones(n, dtype=bool), cap, fill=False), device)
    return DeviceBatch(cols, valid, n, cap)
