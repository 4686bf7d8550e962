"""String expressions over padded byte matrices: the port of the JAX
package's ``ops/strings.py``.

Strings are ``uint8[B, W]`` matrices with int32 lengths
(``columnar/column.py``), so each expression here is a few vectorised
tensor operations over the whole batch, as in the JAX package:

- ``StringComparison`` (``==``, ``<``, ``<=``, ``>``, ``>=``, ``<=>``;
  the analyzer routes every comparison of two strings here);
- ``Length`` (UTF-8 codepoints), ``Upper``/``Lower`` (ASCII only on the
  device: ``incompat``), ``Trim`` (0x20 only);
- ``Substring`` (1-based, byte-indexed, a negative position counts from
  the end);
- ``StringPredicate`` (``startswith``, ``endswith``, ``contains`` with a
  literal pattern), ``StringLocate`` (locate/instr);
- ``Like`` (SQL LIKE with a literal pattern: ``%``, ``_`` matching one
  byte, backslash escape);
- ``StringReplace``, ``Concat``, ``StringReverse`` and ``StringPad``
  (byte-based: ``incompat``);
- the device string casts (``cast_*_device``) that ``Cast`` dispatches
  to;
- ``RLike``, ``RegexpExtract`` and ``RegexpReplace`` over the DFA
  engine of ``ops/regex_device.py``, with ``check_regex_supported`` and
  the simple-pattern transpile ``regex_as_simple``.

A pattern search compares every shift at once: the windows
``data.unfold(1, p, 1)`` (a view, ``[B, W - p + 1, p]``) against the
pattern in one broadcast.  A scan along the width (the replace's greedy
match selection, the casts' digit parsers) is one Python loop over W of
``[B]`` operations, never a loop over rows.  Output widths are the JAX
package's, exactly.  Each class also has the JAX package's ``eval_cpu``
over host strings (codepoint-indexed Python ``str`` operations, a regex
for LIKE, the same DFA for an eligible regex), the CPU fallback and
oracle path, and its TypeSig.  ``Split`` (``array<string>``, which has
no device layout) is evaluated on the host only, as in the JAX package:
the plan rewrite reports its operator as a fallback.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn, round_up_pow2, torch_dtype)
from spark_rapids_tpu_torch.columnar.host import HostCol
from spark_rapids_tpu_torch.ops import expressions as E
from spark_rapids_tpu_torch.ops import regex_device as RX
from spark_rapids_tpu_torch.runtime.device import device_constant
from spark_rapids_tpu_torch.ops.expressions import (
    Expression, Literal, merge_validity, merge_validity_h)


def _pad_to(col: DeviceColumn, w: int) -> torch.Tensor:
    """Pad (with zero bytes) or truncate a string column's byte matrix to
    width ``w``."""
    cur = col.data.shape[1]
    if cur == w:
        return col.data
    if cur < w:
        return torch.nn.functional.pad(col.data, (0, w - cur))
    return col.data[:, :w]


def _lex_lt_le(a: DeviceColumn, b: DeviceColumn):
    """(a < b, a <= b), bytewise lexicographic."""
    w = max(a.data.shape[1], b.data.shape[1])
    am = _pad_to(a, w).to(torch.int32)
    bm = _pad_to(b, w).to(torch.int32)
    diff = am != bm
    any_diff = diff.any(dim=1)
    first = torch.argmax(diff.to(torch.uint8), dim=1)
    rows = torch.arange(am.shape[0], device=am.device)
    ab = am[rows, first]
    bb = bm[rows, first]
    lt = torch.where(any_diff, ab < bb, a.lengths < b.lengths)
    eq = ~any_diff & (a.lengths == b.lengths)
    return lt, lt | eq


@dataclasses.dataclass
class StringComparison(Expression):
    op: str  # eq, lt, le, gt, ge, eqns
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def name(self):
        return {"eq": "EqualTo", "lt": "LessThan", "le": "LessThanOrEqual",
                "gt": "GreaterThan", "ge": "GreaterThanOrEqual",
                "eqns": "EqualNullSafe"}[self.op]

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        validity = merge_validity(l.validity, r.validity)
        if self.op in ("eq", "eqns"):
            w = max(l.data.shape[1], r.data.shape[1])
            eq = (_pad_to(l, w) == _pad_to(r, w)).all(dim=1) & (
                l.lengths == r.lengths)
            if self.op == "eq":
                return DeviceColumn(self.dtype, eq, validity)
            lv, rv = l.valid_mask(), r.valid_mask()
            return DeviceColumn(self.dtype,
                                torch.where(lv & rv, eq, ~lv & ~rv), None)
        lt, le = _lex_lt_le(l, r)
        data = {"lt": lt, "le": le, "gt": ~le, "ge": ~lt}[self.op]
        return DeviceColumn(self.dtype, data, validity)

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        n = len(l.data)
        la = np.array([s.encode() if isinstance(s, str) else s
                       for s in l.data], object)
        ra = np.array([s.encode() if isinstance(s, str) else s
                       for s in r.data], object)
        if self.op == "eq":
            data = np.array([la[i] == ra[i] for i in range(n)])
            return HostCol(self.dtype, data,
                           merge_validity_h(l.validity, r.validity))
        if self.op == "eqns":
            lv, rv = l.valid_mask(), r.valid_mask()
            eq = np.array([la[i] == ra[i] for i in range(n)])
            return HostCol(self.dtype, np.where(lv & rv, eq, ~lv & ~rv),
                           None)
        cmp = {"lt": lambda x, y: x < y, "le": lambda x, y: x <= y,
               "gt": lambda x, y: x > y, "ge": lambda x, y: x >= y}[self.op]
        data = np.array([cmp(la[i], ra[i]) for i in range(n)])
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


def string_comparison(op: str, l: Expression, r: Expression) -> Expression:
    return StringComparison(op, l, r)


def _pattern_tensor(pat: bytes, dev) -> torch.Tensor:
    """The pattern's bytes on ``dev``, uploaded once per pattern and
    device (``device_constant``)."""
    return device_constant(
        ("strings.pattern", bytes(pat)), dev,
        lambda: torch.tensor(list(pat), dtype=torch.uint8))


def _window_match(c: DeviceColumn, pat: bytes,
                  wild: Optional[List[bool]] = None) -> torch.Tensor:
    """``[B, W - p + 1]``: the pattern matches at shift s inside the
    string (``lengths >= s + p``); ``wild[j]`` marks a byte that matches
    anything.  Needs ``0 < p <= W``."""
    p = len(pat)
    dev = c.data.device
    eq = c.data.unfold(1, p, 1) == _pattern_tensor(pat, dev)
    if wild is not None and any(wild):
        eq = eq | _pattern_tensor(bytes(wild), dev).to(torch.bool)
    shifts = torch.arange(eq.shape[1], device=dev)
    return eq.all(dim=2) & (c.lengths[:, None] >= shifts[None, :] + p)


def _shifted(data: torch.Tensor, start: torch.Tensor, ow: int
             ) -> torch.Tensor:
    """``[B, ow]``: each row's bytes from ``start`` on (positions past
    the width repeat its last byte; callers mask by length)."""
    w = data.shape[1]
    cols = torch.arange(ow, device=data.device)
    idx = torch.clamp(start[:, None].long() + cols[None, :], 0, w - 1)
    return torch.gather(data, 1, idx)


def _first_last(c: DeviceColumn, keep: torch.Tensor):
    """(first, end) of the span of ``keep`` bytes per row: the first kept
    position and one past the last; a row with none gives (length, 0)."""
    w = c.data.shape[1]
    any_keep = keep.any(dim=1)
    u = keep.to(torch.uint8)
    first = torch.where(any_keep, torch.argmax(u, dim=1),
                        c.lengths).to(torch.int32)
    last = torch.where(any_keep, w - torch.argmax(u.flip(1), dim=1),
                       0).to(torch.int32)
    return first, last


@dataclasses.dataclass
class Length(Expression):
    """char_length in UTF-8 codepoints: the bytes of the string that are
    not continuation bytes (10xxxxxx)."""

    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.IntegerType)

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        w = c.data.shape[1]
        in_str = (torch.arange(w, device=c.data.device)[None, :]
                  < c.lengths[:, None])
        cont = (c.data & 0xC0) == 0x80
        data = (in_str & ~cont).sum(dim=1).to(torch.int32)
        return DeviceColumn(self.dtype, data, c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        data = np.array([len(s) for s in c.data], np.int32)
        return HostCol(self.dtype, data, c.validity)


@dataclasses.dataclass
class _CaseMap(Expression):
    child: Expression
    UPPER = True
    # per-op incompat gate [REF: GpuOverrides incompat + RapidsConf
    # isIncompatEnabled]: needs spark.rapids.sql.incompatibleOps.enabled
    incompat = ("ASCII-only case mapping on device; non-ASCII bytes pass "
                "through unchanged")

    @property
    def dtype(self):
        return T.StringT

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        d = c.data
        if self.UPPER:
            out = torch.where((d >= ord("a")) & (d <= ord("z")), d - 32, d)
        else:
            out = torch.where((d >= ord("A")) & (d <= ord("Z")), d + 32, d)
        return DeviceColumn(T.StringT, out, c.validity, c.lengths)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        f = str.upper if self.UPPER else str.lower
        data = np.array([f(s) for s in c.data], object)
        return HostCol(T.StringT, data, c.validity)


class Upper(_CaseMap):
    UPPER = True


class Lower(_CaseMap):
    UPPER = False


def string_unary(op: str, child: Expression) -> Expression:
    if op == "length":
        return Length(child)
    if op == "upper":
        return Upper(child)
    if op == "lower":
        return Lower(child)
    raise ValueError(op)


@dataclasses.dataclass
class Substring(Expression):
    """substring(str, pos, len) — 1-based, a negative pos counts from the
    end; byte-indexed (exact for ASCII), as the JAX package's device
    path.  The output width is ``round_up_pow2(min(max(len, 1), W), 8)``
    (a string key's width decides its limb layout downstream); bytes
    past each row's length are zero."""

    child: Expression
    pos: int
    length: int

    @property
    def dtype(self):
        return T.StringT

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        w = c.data.shape[1]
        slen = c.lengths
        if self.pos > 0:
            start = torch.full_like(slen, self.pos - 1)
        elif self.pos == 0:
            start = torch.zeros_like(slen)
        else:
            start = torch.clamp(slen + self.pos, min=0)
        out_len = torch.clamp(slen - start, 0, max(self.length, 0)).to(
            torch.int32)
        ow = round_up_pow2(min(max(self.length, 1), w), 8)
        cols = torch.arange(ow, device=slen.device)
        data = _shifted(c.data, start, ow)
        data = data * (cols[None, :] < out_len[:, None]).to(torch.uint8)
        return DeviceColumn(T.StringT, data, c.validity, out_len)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        out = np.empty(len(c.data), object)
        for i, s in enumerate(c.data):
            p = self.pos
            if p > 0:
                st = p - 1
            elif p == 0:
                st = 0
            else:
                st = max(len(s) + p, 0)
            out[i] = s[st:st + max(self.length, 0)]
        return HostCol(T.StringT, out, c.validity)


@dataclasses.dataclass
class StringPredicate(Expression):
    """startswith / endswith / contains with a literal pattern."""

    op: str
    left: Expression
    right: Expression  # a Literal
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def name(self):
        return {"startswith": "StartsWith", "endswith": "EndsWith",
                "contains": "Contains"}[self.op]

    @property
    def children(self):
        return (self.left, self.right)

    def _pattern(self) -> bytes:
        if not isinstance(self.right, Literal):
            raise NotImplementedError(
                f"{self.name} on TPU requires a literal pattern")
        return str(self.right.value).encode()

    def eval(self, batch):
        c = self.left.eval(batch)
        pat = self._pattern()
        p = len(pat)
        b, w = c.data.shape
        dev = c.data.device
        validity = merge_validity(c.validity,
                                  self.right.eval(batch).validity)
        if p == 0 or p > w:
            return DeviceColumn(self.dtype, torch.full(
                (b,), p == 0, dtype=torch.bool, device=dev), validity)
        pv = _pattern_tensor(pat, dev)
        if self.op == "startswith":
            data = (c.data[:, :p] == pv).all(dim=1) & (c.lengths >= p)
        elif self.op == "endswith":
            idx = torch.clamp(c.lengths[:, None].long() - p
                              + torch.arange(p, device=dev)[None, :],
                              0, w - 1)
            data = ((torch.gather(c.data, 1, idx) == pv).all(dim=1)
                    & (c.lengths >= p))
        else:  # contains: a match at any shift
            data = _window_match(c, pat).any(dim=1)
        return DeviceColumn(self.dtype, data, validity)

    def eval_cpu(self, batch):
        l = self.left.eval_cpu(batch)
        r = self.right.eval_cpu(batch)
        f = {"startswith": str.startswith, "endswith": str.endswith,
             "contains": str.__contains__}[self.op]
        data = np.array([f(l.data[i], r.data[i]) for i in range(len(l.data))])
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


def string_predicate(op, l, r) -> Expression:
    return StringPredicate(op, l, r)


@dataclasses.dataclass
class Trim(Expression):
    """trim/ltrim/rtrim: space (0x20) removal, Spark's defaults.

    [REF: stringFunctions.scala :: GpuStringTrim/TrimLeft/TrimRight]
    A shift-gather like substring, its start and length from the leading
    and trailing space counts."""

    child: Expression
    side: str = "both"  # both | leading | trailing

    @property
    def name(self):
        return {"both": "StringTrim", "leading": "StringTrimLeft",
                "trailing": "StringTrimRight"}[self.side]

    @property
    def dtype(self):
        return T.StringT

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        w = c.data.shape[1]
        pos = torch.arange(w, device=c.data.device)[None, :]
        in_str = pos < c.lengths[:, None]
        # all-space rows: first = length, last = 0, an empty result
        first, last = _first_last(c, in_str & (c.data != 0x20))
        if self.side == "both":
            start, end = first, last
        elif self.side == "leading":
            start, end = first, c.lengths
        else:
            start, end = torch.zeros_like(first), last
        out_len = torch.clamp(end - start, min=0).to(torch.int32)
        g = _shifted(c.data, start, w)
        return DeviceColumn(T.StringT,
                            torch.where(pos < out_len[:, None], g, 0),
                            c.validity, out_len)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        f = {"both": lambda s: s.strip(" "),
             "leading": lambda s: s.lstrip(" "),
             "trailing": lambda s: s.rstrip(" ")}[self.side]
        data = np.array([f(s) for s in c.data], object)
        return HostCol(T.StringT, data, c.validity)


@dataclasses.dataclass
class StringLocate(Expression):
    """locate(substr, str, pos) / instr: 1-based first occurrence at or
    after ``pos``, 0 if absent; a null pattern or input gives null.
    [REF: GpuStringLocate]  Byte-indexed on the device (exact for
    ASCII), codepoint-indexed on the CPU, as in the JAX package."""

    substr: Expression  # a Literal on the device path
    child: Expression
    start: int = 1
    dtype: T.DataType = dataclasses.field(default_factory=T.IntegerType)

    @property
    def children(self):
        return (self.substr, self.child)

    def _pattern(self) -> bytes:
        if not isinstance(self.substr, Literal):
            raise NotImplementedError("locate on TPU needs literal substr")
        return str(self.substr.value).encode()

    def eval(self, batch):
        c = self.child.eval(batch)
        pat = self._pattern()
        p = len(pat)
        b, w = c.data.shape
        dev = c.data.device
        validity = merge_validity(c.validity,
                                  self.substr.eval(batch).validity)
        if self.start < 1 or p > w:
            # Spark: pos < 1 -> 0 (no match)
            return DeviceColumn(self.dtype, torch.zeros(
                (b,), dtype=torch.int32, device=dev), validity)
        if p == 0:
            # Spark: an empty needle -> pos (when pos <= len + 1), else 0
            data = (c.lengths + 1 >= self.start).to(torch.int32) * self.start
            return DeviceColumn(self.dtype, data, validity)
        hits = _window_match(c, pat)
        shifts = torch.arange(hits.shape[1], device=dev)
        hits = hits & (shifts >= self.start - 1)[None, :]
        found = hits.any(dim=1)
        first = torch.argmax(hits.to(torch.uint8), dim=1)
        data = torch.where(found, first + 1, 0).to(torch.int32)
        return DeviceColumn(self.dtype, data, validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        s_ = self.substr.eval_cpu(batch)
        out = np.zeros(len(c.data), np.int32)
        for i in range(len(c.data)):
            if self.start < 1:
                out[i] = 0
                continue
            out[i] = str(c.data[i]).find(str(s_.data[i]),
                                         self.start - 1) + 1
        return HostCol(self.dtype, out,
                       merge_validity_h(c.validity, s_.validity))


def _parse_like(pattern: str, escape: str = "\\"):
    """LIKE pattern -> list of segments; a segment is a list of
    (byte | None) where None = '_' (any byte).  Segments are the literal
    runs between '%'s."""
    segs: List[List] = [[]]
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            segs[-1].extend(pattern[i + 1].encode())
            i += 2
            continue
        if ch == "%":
            segs.append([])
        elif ch == "_":
            segs[-1].append(None)
        else:
            segs[-1].extend(ch.encode())
        i += 1
    return segs


@dataclasses.dataclass
class Like(Expression):
    """SQL LIKE with a literal pattern ('%', '_', backslash escape).

    [REF: GpuLike] Greedy leftmost per '%'-separated segment: an
    anchored head, each middle segment at its leftmost match at or after
    the current position, and a tail that must end exactly at the
    string's length; each segment's match-at-shift matrix is one
    broadcast compare.  '_' matches one byte (exact for ASCII).
    Validity is the child's."""

    child: Expression
    pattern: str
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    @staticmethod
    def _seg_match(c: DeviceColumn, seg) -> torch.Tensor:
        """``[B, W + 1]`` — the segment matches starting at shift s
        (s <= length - p); the shifts past W - p are False."""
        b, w = c.data.shape
        p = len(seg)
        dev = c.data.device
        if p == 0:
            return (torch.arange(w + 1, device=dev)[None, :]
                    <= c.lengths[:, None])
        if p > w:
            return torch.zeros((b, w + 1), dtype=torch.bool, device=dev)
        m = _window_match(c, bytes(0 if by is None else by for by in seg),
                          [by is None for by in seg])
        return torch.nn.functional.pad(m, (0, p))

    def eval(self, batch):
        c = self.child.eval(batch)
        b, w = c.data.shape
        dev = c.data.device
        segs = _parse_like(self.pattern)
        if len(segs) == 1:
            seg = segs[0]
            data = self._seg_match(c, seg)[:, 0] & (c.lengths == len(seg))
            return DeviceColumn(self.dtype, data, c.validity)
        head, mids, tail = segs[0], segs[1:-1], segs[-1]
        shifts = torch.arange(w + 1, device=dev)[None, :]
        ok = torch.ones((b,), dtype=torch.bool, device=dev)
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        if head:
            ok = ok & self._seg_match(c, head)[:, 0]
            pos = torch.full((b,), len(head), dtype=torch.int32, device=dev)
        for seg in mids:
            if not seg:
                continue
            m = self._seg_match(c, seg) & (shifts >= pos[:, None])
            found = m.any(dim=1)
            ok = ok & found
            # argmax returns the first maximum: the leftmost match (bool
            # argmax is not on every build, hence uint8)
            first = torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)
            pos = torch.where(found, first + len(seg), pos)
        if tail:
            end_shift = c.lengths - len(tail)
            m = self._seg_match(c, tail)
            at_end = torch.gather(
                m, 1, torch.clamp(end_shift, 0, w)[:, None].long())[:, 0]
            ok = ok & at_end & (end_shift >= pos)
        return DeviceColumn(self.dtype, ok, c.validity)

    def eval_cpu(self, batch):
        import re as _re
        c = self.child.eval_cpu(batch)
        # translate LIKE -> regex (escape-aware)
        rx = ""
        i = 0
        pat = self.pattern
        while i < len(pat):
            ch = pat[i]
            if ch == "\\" and i + 1 < len(pat):
                rx += _re.escape(pat[i + 1])
                i += 2
                continue
            if ch == "%":
                rx += "(?s:.*)"
            elif ch == "_":
                rx += "(?s:.)"
            else:
                rx += _re.escape(ch)
            i += 1
        prog = _re.compile(rx)
        data = np.array([prog.fullmatch(str(s)) is not None
                         for s in c.data], dtype=bool)
        return HostCol(self.dtype, data, c.validity)


@dataclasses.dataclass
class StringReplace(Expression):
    """replace(str, search, replace) with a literal search and
    replacement.

    [REF: GpuStringReplace] Scatter-free, as in the JAX package: the
    search's match-at-shift matrix (one ``_window_match``), the greedy
    leftmost non-overlapping selection (one pass over the width carrying
    each row's next free position), per-input-byte emit counts, their
    exclusive scan for the output offsets, then every OUTPUT byte finds
    its source byte by one batched ``searchsorted``.  The output width
    is ``round_up_pow2(max(W if lr <= ls else W + (W // ls) * (lr -
    ls), 1), 8)``."""

    child: Expression
    search: str
    replace: str

    @property
    def dtype(self):
        return T.StringT

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        b, w = c.data.shape
        sb = self.search.encode()
        rb = self.replace.encode()
        ls, lr = len(sb), len(rb)
        if ls == 0 or ls > w:
            return c
        dev = c.data.device
        match = torch.nn.functional.pad(_window_match(c, sb), (0, ls - 1))
        # greedy leftmost non-overlapping selection; a byte inside a
        # chosen span but not its start is covered
        chosen = torch.empty((b, w), dtype=torch.bool, device=dev)
        covered = torch.empty((b, w), dtype=torch.bool, device=dev)
        next_free = torch.zeros((b,), dtype=torch.int32, device=dev)
        for j in range(w):
            ch = match[:, j] & (next_free <= j)
            next_free = torch.where(ch, j + ls, next_free)
            chosen[:, j] = ch
            covered[:, j] = (next_free > j) & ~ch
        in_str = (torch.arange(w, device=dev)[None, :]
                  < c.lengths[:, None])
        emit = torch.where(chosen, lr, (~covered & in_str).to(torch.int32))
        ends = torch.cumsum(emit, dim=1)  # inclusive, int64
        off = ends - emit
        out_len = ends[:, -1].to(torch.int32)
        wout = round_up_pow2(
            max(w if lr <= ls else w + (w // ls) * (lr - ls), 1), 8)
        ks = torch.arange(wout, device=dev)
        j = torch.searchsorted(ends, ks.expand(b, -1).contiguous(),
                               side="right")
        j = torch.clamp(j, 0, w - 1)
        rv = _pattern_tensor(rb or b"\0", dev)
        rel = ks[None, :] - torch.gather(off, 1, j)
        rep_byte = rv[torch.clamp(rel, 0, max(lr - 1, 0))]
        by = torch.where(torch.gather(chosen, 1, j), rep_byte,
                         torch.gather(c.data, 1, j))
        out = torch.where(ks[None, :] < out_len[:, None], by, 0)
        return DeviceColumn(T.StringT, out, c.validity, out_len)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        if not self.search:
            return HostCol(T.StringT, c.data, c.validity)
        data = np.array([str(s).replace(self.search, self.replace)
                         for s in c.data], object)
        return HostCol(T.StringT, data, c.validity)


@dataclasses.dataclass
class Concat(Expression):
    """concat(...): null if any input is null.  Each piece is gathered
    into place behind the previous pieces' lengths; the output width is
    ``round_up_pow2(sum of the input widths, 8)``."""

    exprs: List[Expression]

    @property
    def dtype(self):
        return T.StringT

    @property
    def children(self):
        return tuple(self.exprs)

    def eval(self, batch):
        cols = [e.eval(batch) for e in self.exprs]
        ow = round_up_pow2(sum(c.data.shape[1] for c in cols), 8)
        b = batch.capacity
        dev = batch.device
        out = torch.zeros((b, ow), dtype=torch.uint8, device=dev)
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        col_idx = torch.arange(ow, device=dev)[None, :]
        for c in cols:
            rel = col_idx - pos[:, None]
            in_piece = (rel >= 0) & (rel < c.lengths[:, None])
            src = torch.gather(
                c.data, 1, torch.clamp(rel, 0, c.data.shape[1] - 1))
            out = torch.where(in_piece, src, out)
            pos = pos + c.lengths
        validity = merge_validity(*[c.validity for c in cols])
        return DeviceColumn(T.StringT, out, validity, pos)

    def eval_cpu(self, batch):
        cols = [e.eval_cpu(batch) for e in self.exprs]
        n = len(cols[0].data)
        data = np.array(["".join(str(c.data[i]) for c in cols)
                         for i in range(n)], object)
        return HostCol(T.StringT, data,
                       merge_validity_h(*[c.validity for c in cols]))


# ---------------------------------------------------------------------------
# Device string casts [REF: GpuCast.scala: castToString / castStringToInt /
# castStringToBool / castStringToFloat].  torch has no uint64 arithmetic,
# so the unsigned 64-bit steps of the JAX package run on int64 bit
# patterns: digits come from the non-positive value, and an unsigned
# compare is a signed compare after flipping the top bit.
# ---------------------------------------------------------------------------

_LONG_STR_W = 24  # "-9223372036854775808" fits with room, pow-2-ish pad
_TOP = -(1 << 63)  # the int64 with only the top bit set


def _as_int64(u: int) -> int:
    """The int64 holding the bits of the unsigned 64-bit value ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _unsigned_gt(a: torch.Tensor, b) -> torch.Tensor:
    """``a > b`` with both read as unsigned 64-bit values (``b`` an int64
    tensor of bit patterns, or a non-negative Python int below 2^64)."""
    if isinstance(b, int):
        b = _as_int64(b) ^ _TOP
    else:
        b = b ^ _TOP
    return (a ^ _TOP) > b


def cast_int_to_string_device(c: DeviceColumn) -> DeviceColumn:
    """int family -> decimal string (exact digit extraction), width 24."""
    v = c.data.to(torch.int64)
    neg = v < 0
    # digits of the non-positive value: |Long.MIN| = 2^63 has no int64
    m = torch.where(neg, v, -v)
    digs = []
    for _ in range(19):
        digs.append((-torch.fmod(m, 10)).to(torch.uint8))
        m = torch.div(m, 10, rounding_mode="trunc")
    dig = torch.stack(digs[::-1], dim=1)  # [B, 19] most significant first
    nz = dig != 0
    lead = torch.where(nz.any(dim=1), torch.argmax(nz.to(torch.uint8), dim=1),
                       18)
    negi = neg.to(torch.int64)
    out_len = (19 - lead + negi).to(torch.int32)
    posn = torch.arange(_LONG_STR_W, device=v.device)[None, :]
    src = torch.clamp(lead[:, None] + posn - negi[:, None], 0, 18)
    ch = torch.gather(dig, 1, src) + ord("0")
    out = torch.where(neg[:, None] & (posn == 0), ord("-"), ch)
    out = torch.where(posn < out_len[:, None], out, 0)
    return DeviceColumn(T.StringT, out, c.validity, out_len)


def cast_bool_to_string_device(c: DeviceColumn) -> DeviceColumn:
    """boolean -> "true"/"false" in an 8-byte matrix."""
    dev = c.data.device
    cond = c.data.to(torch.bool)
    out = torch.where(cond[:, None], _pattern_tensor(b"true\0\0\0\0", dev),
                      _pattern_tensor(b"false\0\0\0", dev))
    return DeviceColumn(T.StringT, out, c.validity,
                        5 - cond.to(torch.int32))


def _trim_bounds(c: DeviceColumn):
    """(start, end) of the whitespace-trimmed span per row: Spark trims
    ASCII control characters and space like Java's trim (bytes <= 0x20),
    unlike ``Trim``."""
    w = c.data.shape[1]
    in_str = (torch.arange(w, device=c.data.device)[None, :]
              < c.lengths[:, None])
    return _first_last(c, in_str & (c.data > 0x20))


def cast_string_to_int_device(c: DeviceColumn, dst: T.DataType
                              ) -> DeviceColumn:
    """string -> integral (Spark non-ANSI): trim, [+-], digits, an
    optional fraction truncated toward zero; invalid or overflowing
    input -> null.  The magnitude accumulates as an unsigned 64-bit
    value, held in int64 bits: 2^64 - 1 = lim * 10 + 5, so a digit at
    ``acc > lim``, or above 5 at ``acc == lim``, overflows."""
    b, w = c.data.shape
    dev = c.data.device
    start, end = _trim_bounds(c)

    def flag():
        return torch.zeros((b,), dtype=torch.bool, device=dev)

    acc = torch.zeros((b,), dtype=torch.int64, device=dev)
    neg, seen_digit, seen_dot, bad, overflow = (flag(), flag(), flag(),
                                                flag(), flag())
    lim = ((1 << 64) - 1) // 10
    for j in range(w):
        by = c.data[:, j].to(torch.int32)
        active = (start <= j) & (end > j) & ~bad
        is_digit = (by >= ord("0")) & (by <= ord("9"))
        is_sign = ((by == ord("+")) | (by == ord("-"))) & (start == j)
        is_dot = (by == ord(".")) & ~seen_dot
        d = (by - ord("0")).to(torch.int64)
        do_acc = active & is_digit & ~seen_dot
        overflow = overflow | (do_acc & (
            _unsigned_gt(acc, lim) | ((acc == lim) & (d > 5))))
        acc = torch.where(do_acc, acc * 10 + d, acc)  # wraps as uint64
        seen_digit = seen_digit | (active & is_digit)
        neg = neg | (active & is_sign & (by == ord("-")))
        seen_dot = seen_dot | (active & is_dot)
        bad = bad | (active & ~(is_digit | is_sign | is_dot))
    # a magnitude of 2^63 only for Long.MIN
    max_mag = torch.where(neg, _TOP, (1 << 63) - 1)
    overflow = overflow | _unsigned_gt(acc, max_mag)
    signed = torch.where(neg, ~acc + 1, acc)
    lo, hi = E._INT_RANGES[type(dst)]
    valid = seen_digit & ~bad & ~overflow & (signed >= lo) & (signed <= hi)
    validity = valid if c.validity is None else (c.validity & valid)
    return DeviceColumn(dst, signed.to(torch_dtype(dst)), validity)


_TRUE_WORDS = [b"true", b"t", b"yes", b"y", b"1"]
_FALSE_WORDS = [b"false", b"f", b"no", b"n", b"0"]


def _trimmed_lower(c: DeviceColumn):
    """(bytes of the trimmed span, ASCII-lowercased and zero past it;
    its length) per row."""
    w = c.data.shape[1]
    start, end = _trim_bounds(c)
    tlen = end - start
    g = _shifted(c.data, start, w)
    low = torch.where((g >= ord("A")) & (g <= ord("Z")), g + 32, g)
    in_t = torch.arange(w, device=g.device)[None, :] < tlen[:, None]
    return torch.where(in_t, low, 0), tlen


def _word_eq(low: torch.Tensor, tlen: torch.Tensor, word: bytes
             ) -> torch.Tensor:
    p = len(word)
    if p > low.shape[1]:
        return torch.zeros((low.shape[0],), dtype=torch.bool,
                           device=low.device)
    return ((low[:, :p] == _pattern_tensor(word, low.device)).all(dim=1)
            & (tlen == p))


def cast_string_to_bool_device(c: DeviceColumn) -> DeviceColumn:
    """string -> boolean: the trimmed, lowercased word is one of
    Spark's true or false words, else null."""
    low, tlen = _trimmed_lower(c)
    is_true = _word_eq(low, tlen, _TRUE_WORDS[0])
    for word in _TRUE_WORDS[1:]:
        is_true = is_true | _word_eq(low, tlen, word)
    is_false = _word_eq(low, tlen, _FALSE_WORDS[0])
    for word in _FALSE_WORDS[1:]:
        is_false = is_false | _word_eq(low, tlen, word)
    valid = is_true | is_false
    validity = valid if c.validity is None else (c.validity & valid)
    return DeviceColumn(T.BooleanT, is_true, validity)


def _pow10(k: int) -> float:
    try:
        return 10.0 ** k
    except OverflowError:
        return float("inf")


_POW10 = np.array([_pow10(k) for k in range(351)], np.float64)


def cast_string_to_float_device(c: DeviceColumn, dst: T.DataType
                                ) -> DeviceColumn:
    """string -> float/double: sign, digits, '.', digits, [eE][sign]digits,
    'inf'/'infinity'/'nan' (case-insensitive).

    Correctly rounded when the mantissa fits 2^53 and |10-exponent| <= 22
    (an exact f64 intermediate); beyond that it may differ from Java's
    parseDouble by 1 ulp, so the plan rewrite runs it on the device only
    under spark.rapids.sql.castStringToFloat.enabled, like the
    reference."""
    b, w = c.data.shape
    dev = c.data.device
    low, tlen = _trimmed_lower(c)
    low = low.to(torch.int32)
    is_nan = _word_eq(low, tlen, b"nan")
    inf_pat = torch.zeros((b,), dtype=torch.bool, device=dev)
    sign_inf = torch.zeros((b,), dtype=torch.bool, device=dev)
    for word in (b"inf", b"infinity", b"+inf", b"-inf", b"+infinity",
                 b"-infinity"):
        m = _word_eq(low, tlen, word)
        inf_pat = inf_pat | m
        if word[0:1] == b"-":
            sign_inf = sign_inf | m

    def flag():
        return torch.zeros((b,), dtype=torch.bool, device=dev)

    # the general numeric parse
    mant = torch.zeros((b,), dtype=torch.float64, device=dev)
    frac_digits = torch.zeros((b,), dtype=torch.int32, device=dev)
    exp_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    (neg, eneg, seen_digit, seen_dot, in_exp, seen_edigit, seen_esign,
     bad) = (flag() for _ in range(8))
    for j in range(w):
        by = low[:, j]
        active = (tlen > j) & ~bad
        is_digit = (by >= ord("0")) & (by <= ord("9"))
        d = (by - ord("0")).to(torch.float64)
        # ONE sign allowed, only at the start or directly after 'e'
        after_e = in_exp & ~seen_edigit & ~seen_esign
        is_sign = (by == ord("+")) | (by == ord("-"))
        sign_ok = is_sign if j == 0 else is_sign & after_e
        seen_esign = seen_esign | (active & is_sign & after_e)
        is_dot = (by == ord(".")) & ~seen_dot & ~in_exp
        is_e = (by == ord("e")) & seen_digit & ~in_exp
        mant_step = active & is_digit & ~in_exp
        mant = torch.where(mant_step, mant * 10.0 + d, mant)
        frac_digits = torch.where(mant_step & seen_dot, frac_digits + 1,
                                  frac_digits)
        exp_step = active & is_digit & in_exp
        exp_acc = torch.where(
            exp_step, torch.clamp(exp_acc * 10 + (by - ord("0")), max=9999),
            exp_acc)
        seen_edigit = seen_edigit | exp_step
        seen_digit = seen_digit | (active & is_digit & ~in_exp)
        minus = active & sign_ok & (by == ord("-"))
        if j == 0:
            neg = neg | minus
        else:
            eneg = eneg | minus
        seen_dot = seen_dot | (active & is_dot)
        in_exp = in_exp | (active & is_e)
        bad = bad | (active & ~(is_digit | sign_ok | is_dot | is_e))
    exp = torch.where(eneg, -exp_acc, exp_acc) - frac_digits
    # 10^exp by an exact split: 10^|e| is exact for |e| <= 22; the
    # powers come from a table of correctly rounded doubles, since
    # torch.pow(10.0, k) is 1 ulp off at k = 23, 45, 165, 210, 250, 304
    ae = torch.clamp(exp.abs(), 0, 350).long()
    pow10 = device_constant("strings.pow10", dev,
                            lambda: torch.from_numpy(_POW10))
    p1 = pow10[torch.clamp(ae, max=22)]
    p2 = pow10[torch.clamp(ae - 22, min=0)]
    val = torch.where(exp >= 0, mant * p1 * p2, mant / p1 / p2)
    val = torch.where(neg, -val, val)
    ok_num = seen_digit & ~bad & (~in_exp | seen_edigit)
    val = torch.where(is_nan, float("nan"), val)
    val = torch.where(inf_pat, torch.where(sign_inf, float("-inf"),
                                           float("inf")), val)
    valid = ok_num | is_nan | inf_pat
    validity = valid if c.validity is None else (c.validity & valid)
    return DeviceColumn(dst, val.to(torch_dtype(dst)), validity)


# ---------------------------------------------------------------------------
# Regular expressions [REF: RegexParser/CudfRegexTranspiler,
# stringFunctions.scala :: GpuRLike/GpuRegExpExtract/GpuRegExpReplace]
#
# Simple patterns transpile to the device predicates at analysis time
# (plan/analysis.py); a pattern inside the DFA subset of
# ops/regex_device.py runs its tables on the device (and the same DFA on
# the CPU oracle); anything else evaluates on the host through Python's
# ``re`` with a tag reason.  Possessive quantifiers and \p{...} classes
# raise at analysis.
# ---------------------------------------------------------------------------

_RE_META = set(".^$*+?{}[]|()\\")


def regex_as_simple(pattern: str):
    """(kind, literal) for patterns expressible as device predicates:
    'eq' (^lit$), 'startswith' (^lit), 'endswith' (lit$), 'contains'
    (bare literal); else None."""
    if any(ch in _RE_META for ch in
           pattern.replace("^", "", 1).rstrip("$")
           if ch not in "^$") or "\\" in pattern:
        return None
    anchored_l = pattern.startswith("^")
    anchored_r = pattern.endswith("$") and not pattern.endswith("\\$")
    body = pattern[1 if anchored_l else 0:
                   -1 if anchored_r else len(pattern)]
    if any(ch in _RE_META for ch in body):
        return None
    if anchored_l and anchored_r:
        return ("eq", body)
    if anchored_l:
        return ("startswith", body)
    if anchored_r:
        return ("endswith", body)
    return ("contains", body)


def check_regex_supported(pattern: str) -> None:
    """Reject Java-only constructs Python's ``re`` would misinterpret:
    possessive quantifiers (a*+) and \\p{...} classes, scanned with
    escape and class awareness so that '[*+]' or '\\*+' stay legal."""
    import re as _re
    from spark_rapids_tpu_torch.plan.analysis import AnalysisException
    i, in_class = 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            if i + 1 < len(pattern) and pattern[i + 1] in "pP":
                raise AnalysisException(
                    f"regex construct \\{pattern[i + 1]}{{...}} "
                    f"(Java-only) is not supported: {pattern!r}")
            i += 2
            continue
        if in_class:
            in_class = ch != "]"
            i += 1
            continue
        if ch == "[":
            in_class = True
        elif (ch in "*+?" and i + 1 < len(pattern)
                and pattern[i + 1] == "+"):
            # '{n}+' needs no special case: re.compile rejects it below
            raise AnalysisException(
                f"possessive quantifier '{ch}+' (Java-only) is not "
                f"supported: {pattern!r}")
        i += 1
    try:
        _re.compile(pattern)
    except _re.error as e:
        raise AnalysisException(f"invalid regex {pattern!r}: {e}")


def _host_to_matrix(data):
    """Host object array of strings -> (uint8[n, W] matrix, int32[n])."""
    enc = [(v.encode() if isinstance(v, str) else bytes(v))
           for v in data]
    w = max((len(e) for e in enc), default=1) or 1
    mat = np.zeros((len(enc), w), np.uint8)
    lens = np.zeros(len(enc), np.int32)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, np.uint8)
        lens[i] = len(e)
    return mat, lens


def _matrix_to_host(mat, lens) -> np.ndarray:
    out = np.empty(mat.shape[0], object)
    for i in range(mat.shape[0]):
        out[i] = bytes(mat[i, :int(lens[i])]).decode("utf-8", "replace")
    return out


def _has_group_ref(repl: str) -> bool:
    """True when the replacement is NOT a plain literal ($n references
    or any backslash escape: those stay on the Python ``re`` path)."""
    return "\\" in repl or any(
        repl[i] == "$" and i + 1 < len(repl) and repl[i + 1].isdigit()
        for i in range(len(repl)))


@dataclasses.dataclass
class RLike(Expression):
    """Regex match (Java Pattern.find semantics).

    The device path interprets the DFA tables over the byte matrix
    (ops/regex_device.py, the CudfRegexTranspiler analog); the CPU
    oracle runs the SAME DFA for device-eligible patterns, so both paths
    agree byte for byte.  Patterns outside the subset stay on Python's
    ``re`` with a tag reason."""

    child: Expression
    pattern: str
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def children(self):
        return (self.child,)

    def _rx(self):
        if not hasattr(self, "_rx_cache"):
            object.__setattr__(self, "_rx_cache",
                               RX.compile_regex(self.pattern))
        return self._rx_cache

    def device_support_reason(self, conf):
        if self._rx() is None:
            return (f"regex {self.pattern!r} outside the device DFA "
                    "subset (lazy/possessive quantifiers, backrefs, "
                    "lookaround, \\b, mid-pattern anchors, non-ASCII)")
        return None

    def eval(self, batch):
        c = self.child.eval(batch)
        got = RX.match_any(c.data, c.lengths, self._rx(), torch)
        return DeviceColumn(self.dtype, got, c.validity)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        rx = self._rx()
        if rx is not None:
            mat, lens = _host_to_matrix(c.data)
            got = RX.match_any(mat, lens, rx, np)
            return HostCol(self.dtype, got, c.validity)
        import re as _re
        crx = _re.compile(self.pattern)
        out = np.fromiter((crx.search(str(v)) is not None for v in c.data),
                          bool, len(c.data))
        return HostCol(self.dtype, out, c.validity)


@dataclasses.dataclass
class RegexpExtract(Expression):
    """regexp_extract: group ``idx`` of the first match, '' if none.

    The device path (idx = 0, no alternation) takes the leftmost-longest
    DFA match and gathers its bytes; the CPU oracle runs the same DFA
    when eligible."""

    child: Expression
    pattern: str
    idx: int
    dtype: T.DataType = dataclasses.field(default_factory=T.StringType)

    @property
    def children(self):
        return (self.child,)

    def _rx(self):
        if not hasattr(self, "_rx_cache"):
            rx = RX.compile_regex(self.pattern)
            if rx is not None and (self.idx != 0 or rx.has_alternation):
                rx = None  # group capture / greedy-vs-longest traps
            object.__setattr__(self, "_rx_cache", rx)
        return self._rx_cache

    def device_support_reason(self, conf):
        if self._rx() is None:
            if self.idx != 0:
                return ("regexp_extract group index > 0 needs capture "
                        "groups — not in the device DFA engine")
            return (f"regex {self.pattern!r} outside the device DFA "
                    "subset (or alternation, where greedy != longest)")
        return None

    def eval(self, batch):
        c = self.child.eval(batch)
        mat, lens, _has = RX.extract_first(c.data, c.lengths, self._rx(),
                                           torch)
        return DeviceColumn(self.dtype, mat, c.validity, lens)

    def eval_cpu(self, batch):
        rx = self._rx()
        if rx is not None:
            c = self.child.eval_cpu(batch)
            mat, lens, _has = RX.extract_first(*_host_to_matrix(c.data), rx,
                                               np)
            return HostCol(self.dtype, _matrix_to_host(mat, lens),
                           c.validity)
        import re as _re
        crx = _re.compile(self.pattern)
        c = self.child.eval_cpu(batch)
        out = np.empty(len(c.data), object)
        for i, v in enumerate(c.data):
            m = crx.search(str(v))
            out[i] = (m.group(self.idx) or "") if m else ""
        return HostCol(self.dtype, out, c.validity)


def _java_repl_to_py(repl: str) -> str:
    """Translate Java's $1 group references to Python's \\1."""
    out = []
    i = 0
    while i < len(repl):
        ch = repl[i]
        if ch == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            out.append("\\" + repl[i + 1])
            i += 2
            continue
        if ch == "\\" and i + 1 < len(repl):
            out.append("\\\\" if repl[i + 1] == "\\" else repl[i + 1])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


@dataclasses.dataclass
class RegexpReplace(Expression):
    """regexp_replace with Java $n references in the replacement.

    The device path (a literal replacement, no alternation, a pattern
    that cannot match empty) rebuilds the leftmost non-overlapping DFA
    matches through a prefix-sum byte layout; the CPU oracle shares the
    DFA when eligible."""

    child: Expression
    pattern: str
    replacement: str
    dtype: T.DataType = dataclasses.field(default_factory=T.StringType)

    @property
    def children(self):
        return (self.child,)

    def _rx(self):
        if not hasattr(self, "_rx_cache"):
            rx = RX.compile_regex(self.pattern)
            if rx is not None and (
                    rx.has_alternation or rx.matches_empty
                    or _has_group_ref(self.replacement)
                    or any(ord(ch) > 127 for ch in self.replacement)):
                rx = None
            object.__setattr__(self, "_rx_cache", rx)
        return self._rx_cache

    def device_support_reason(self, conf):
        if self._rx() is None:
            return (f"regexp_replace({self.pattern!r}) outside the "
                    "device DFA subset (alternation, empty-matching "
                    "patterns, $n group references, non-ASCII)")
        return None

    def eval(self, batch):
        c = self.child.eval(batch)
        mat, lens = RX.replace_all(c.data, c.lengths, self._rx(),
                                   self.replacement.encode(), torch)
        return DeviceColumn(self.dtype, mat, c.validity, lens)

    def eval_cpu(self, batch):
        rx = self._rx()
        if rx is not None:
            c = self.child.eval_cpu(batch)
            mat, lens = RX.replace_all(*_host_to_matrix(c.data), rx,
                                       self.replacement.encode(), np)
            return HostCol(self.dtype, _matrix_to_host(mat, lens),
                           c.validity)
        import re as _re
        crx = _re.compile(self.pattern)
        repl = _java_repl_to_py(self.replacement)
        c = self.child.eval_cpu(batch)
        out = np.empty(len(c.data), object)
        for i, v in enumerate(c.data):
            out[i] = crx.sub(repl, str(v))
        return HostCol(self.dtype, out, c.validity)


# ---------------------------------------------------------------------------
# reverse / lpad / rpad on the byte matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Split(Expression):
    """split(str, regex, limit) -> array<string>, on the host only (an
    array of strings has no device layout).  Java's ``limit``: above 0,
    at most ``limit`` parts, the last one holding the rest; 0, every
    part with the trailing empty ones dropped; below 0, every part."""

    child: Expression
    pattern: str
    limit: int = -1

    @property
    def dtype(self):
        return T.ArrayType(T.StringT)

    @property
    def children(self):
        return (self.child,)

    def eval_cpu(self, batch):
        import re as _re
        rx = _re.compile(self.pattern)
        c = self.child.eval_cpu(batch)
        out = np.empty(len(c.data), object)
        for i, v in enumerate(c.data):
            s = str(v)
            if self.limit > 0:
                out[i] = rx.split(s, maxsplit=self.limit - 1)
            else:
                parts = rx.split(s)
                if self.limit == 0:
                    # Java's Pattern.split(limit=0) drops trailing empties
                    while parts and parts[-1] == "":
                        parts.pop()
                out[i] = parts
        return HostCol(self.dtype, out, c.validity)


@dataclasses.dataclass
class StringReverse(Expression):
    """Byte-wise reverse (Spark's for ASCII; a multi-byte UTF-8 sequence
    reverses bytewise on the device, while the CPU path is
    character-correct)."""

    child: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.StringType)
    incompat = "byte-based reverse differs from Spark on non-ASCII"

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        w = c.data.shape[1]
        j = torch.arange(w, device=c.data.device)[None, :]
        src = torch.clamp(c.lengths[:, None] - 1 - j, 0, max(w - 1, 0))
        out = torch.gather(c.data, 1, src)
        out = torch.where(j < c.lengths[:, None], out, 0)
        return DeviceColumn(self.dtype, out, c.validity, c.lengths)

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        out = np.array([str(v)[::-1] for v in c.data], object)
        return HostCol(self.dtype, out, c.validity)


@dataclasses.dataclass
class StringPad(Expression):
    """lpad/rpad to ``target`` bytes with a cyclic pad string; the output
    width is ``max(target, 1)``.

    [REF: stringFunctions.scala :: GpuStringLPad/GpuStringRPad]
    Byte-indexed on the device (ASCII-exact; the CPU oracle is
    byte-based too, so both paths agree)."""

    child: Expression
    target: int
    pad: str
    left: bool
    dtype: T.DataType = dataclasses.field(default_factory=T.StringType)
    incompat = "byte-based padding differs from Spark on non-ASCII"

    @property
    def name(self):
        return "Lpad" if self.left else "Rpad"

    @property
    def children(self):
        return (self.child,)

    def eval(self, batch):
        c = self.child.eval(batch)
        b, w = c.data.shape
        dev = c.data.device
        L = max(int(self.target), 0)
        width = max(L, 1)
        pad_b = self.pad.encode()
        padv = _pattern_tensor(pad_b or b"\0", dev)
        plen = max(len(pad_b), 1)
        j = torch.arange(width, device=dev)[None, :]
        ln = torch.clamp(c.lengths, max=L)[:, None]  # kept source bytes
        # an empty pad only truncates (str[:L]); else the result is
        # exactly L bytes with the pad cycling through the gap
        out_len = (torch.full((b, 1), L, dtype=torch.int32, device=dev)
                   if pad_b else ln)
        if self.left:
            shift = out_len - ln
            data_part = torch.gather(c.data, 1,
                                     torch.clamp(j - shift, 0, w - 1))
            out = torch.where(j < shift, padv[j % plen], data_part)
        else:
            data_part = torch.gather(c.data, 1,
                                     torch.clamp(j, max=w - 1).expand(b, -1))
            out = torch.where(j < ln, data_part, padv[(j - ln) % plen])
        out = torch.where(j < out_len, out, 0)
        return DeviceColumn(self.dtype, out, c.validity, out_len[:, 0])

    def eval_cpu(self, batch):
        c = self.child.eval_cpu(batch)
        L = max(int(self.target), 0)
        pad_b = self.pad.encode()
        out = np.empty(len(c.data), object)
        for i, v in enumerate(c.data):
            sb = str(v).encode()
            if len(sb) >= L or not pad_b:
                r = sb[:L]
            else:
                fill = (pad_b * ((L - len(sb)) // len(pad_b) + 1))[
                    :L - len(sb)]
                r = (fill + sb) if self.left else (sb + fill)
            out[i] = r.decode(errors="replace")
        return HostCol(self.dtype, out, c.validity)


# -- TypeSig declarations (the JAX package's, see expressions.py) ----------
_STR_INT = E.SIG_STRINGY | E.SIG_INTEGRAL
for _cls in (Upper, Lower, Trim, StringReverse, Concat, StringReplace,
             RegexpExtract, RegexpReplace):
    _cls.type_sig = E.SIG_STRINGY
Length.type_sig = E.SIG_INTEGRAL
Length.input_sig = E.SIG_STRINGY
for _cls in (StringComparison, StringPredicate, Like, RLike):
    _cls.type_sig = E.SIG_BOOLEAN
    _cls.input_sig = E.SIG_STRINGY
for _cls in (Substring, StringPad):
    _cls.type_sig = E.SIG_STRINGY
    _cls.input_sig = _STR_INT
StringLocate.type_sig = E.SIG_INTEGRAL
StringLocate.input_sig = _STR_INT
Split.type_sig = frozenset({"array"})
Split.input_sig = E.SIG_STRINGY
