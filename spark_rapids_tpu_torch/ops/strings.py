"""String expressions over padded byte matrices — the subset of the JAX
package's ``ops/strings.py`` that the TPC-H queries need.

Strings are ``uint8[B, W]`` matrices with int32 lengths
(``columnar/column.py``), so each expression here is a few vectorised
tensor operations over the whole batch, as in the JAX package:

- ``StringComparison`` (``==``, ``<``, ``<=``, ``>``, ``>=``; the
  analyzer routes every comparison of two strings here);
- ``Substring`` (1-based, byte-indexed, a negative position counts from
  the end);
- ``StringPredicate`` (``startswith``, ``endswith``, ``contains`` with a
  literal pattern);
- ``Like`` (SQL LIKE with a literal pattern: ``%``, ``_`` matching one
  byte, backslash escape).

A pattern search compares every shift at once: the windows
``data.unfold(1, p, 1)`` (a view, ``[B, W - p + 1, p]``) against the
pattern in one broadcast.  Each class also has the JAX package's
``eval_cpu`` over host strings (codepoint-indexed, Python ``str``
operations and a regex for LIKE), the CPU fallback and oracle path, and
its TypeSig.  Length, the case maps, trim, locate,
replace, concat, reverse, pad, the string casts and RLike are later
slices; the analyzer raises ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, round_up_pow2
from spark_rapids_tpu_torch.columnar.host import HostCol
from spark_rapids_tpu_torch.ops import expressions as E
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
    op: str  # eq, lt, le, gt, ge
    left: Expression
    right: Expression
    dtype: T.DataType = dataclasses.field(default_factory=T.BooleanType)

    @property
    def name(self):
        return {"eq": "EqualTo", "lt": "LessThan", "le": "LessThanOrEqual",
                "gt": "GreaterThan", "ge": "GreaterThanOrEqual"}[self.op]

    @property
    def children(self):
        return (self.left, self.right)

    def eval(self, batch):
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        validity = merge_validity(l.validity, r.validity)
        if self.op == "eq":
            w = max(l.data.shape[1], r.data.shape[1])
            eq = (_pad_to(l, w) == _pad_to(r, w)).all(dim=1) & (
                l.lengths == r.lengths)
            return DeviceColumn(self.dtype, eq, validity)
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
        cmp = {"lt": lambda x, y: x < y, "le": lambda x, y: x <= y,
               "gt": lambda x, y: x > y, "ge": lambda x, y: x >= y}[self.op]
        data = np.array([cmp(la[i], ra[i]) for i in range(n)])
        return HostCol(self.dtype, data,
                       merge_validity_h(l.validity, r.validity))


def string_comparison(op: str, l: Expression, r: Expression) -> Expression:
    return StringComparison(op, l, r)


def _pattern_tensor(pat: bytes, dev) -> torch.Tensor:
    """The pattern's bytes on ``dev``, copied without waiting for the
    device (the host buffer is staged at once)."""
    return torch.tensor(list(pat), dtype=torch.uint8).to(dev,
                                                         non_blocking=True)


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
        idx = torch.clamp(start[:, None].long() + cols[None, :], 0, w - 1)
        data = torch.gather(c.data, 1, idx)
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


# -- TypeSig declarations (the JAX package's, see expressions.py) ----------
_STR_INT = E.SIG_STRINGY | E.SIG_INTEGRAL
for _cls in (StringComparison, StringPredicate, Like):
    _cls.type_sig = E.SIG_BOOLEAN
    _cls.input_sig = E.SIG_STRINGY
Substring.type_sig = E.SIG_STRINGY
Substring.input_sig = _STR_INT
