"""Device regex engine: a Java-regex subset compiled to DFA tables that
run over the padded byte matrices.

The port's own copy of the JAX package's ``ops/regex_device.py``
[REF: sql-plugin/../RegexParser.scala :: CudfRegexTranspiler].  The
compiler is pure Python/numpy and identical: at plan time a literal
pattern is parsed over the supported subset, built into a Thompson NFA,
then into a DFA over the 256-byte alphabet by subset construction:
``DeviceRegex`` holds the transition table ``int32[S, 256]``, ``accept``
``bool[S]`` and the flags.  An unsupported construct gives ``None`` and
the expression stays on the host ``re`` path with a tag reason.

Matching is one shared simulation with two branches, numpy for the CPU
oracle (``eval_cpu``) and torch for the card, so both agree byte for
byte: every match start runs at once as a ``[B, W + 1]`` state matrix,
and step j feeds byte j to every run whose start s <= j.  The result is
the leftmost-LONGEST match-length table, equal to Java's leftmost-greedy
result for the gated subset (alternation is excluded from extract and
replace, where greedy and longest can differ).  The torch branch moves
the table and ``accept`` to the card once per compiled pattern
(``device_tables``) and steps only the starts that can be active
(s <= j), one Python loop over W.

Byte-level semantics: ``.`` and classes act on BYTES.  For ASCII data
this equals Java exactly; a multi-byte UTF-8 code point counts as
several ``.`` positions (a documented divergence, the same on both
paths).

Supported: literals, escapes (\\n \\t \\r \\d \\D \\w \\W \\s \\S \\.
etc.), ``.``, character classes with ranges and negation,
``(?:...)``/``(...)`` grouping (no capture extraction), ``|``, greedy
``* + ? {m} {m,} {m,n}``, ``^`` at the pattern's start, ``$`` at its
end (Java find semantics: also before a final \\n, \\r\\n or \\r).
Rejected: lazy and possessive quantifiers, backreferences, lookaround,
mid-pattern anchors, \\b, \\p{...}, non-ASCII pattern characters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

MAX_DFA_STATES = 192
_LINE_TERMS = (10, 13)  # \n, \r — '.' excludes these (Java non-DOTALL)


class Unsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# Parser → NFA (Thompson construction)
# ---------------------------------------------------------------------------

class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[np.ndarray, int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1


def _class_bytes(chars) -> np.ndarray:
    m = np.zeros(256, bool)
    for c in chars:
        m[c] = True
    return m


_D = _class_bytes(range(48, 58))
_W = _class_bytes(list(range(48, 58)) + list(range(65, 91))
                  + list(range(97, 123)) + [95])
_S = _class_bytes([32, 9, 10, 11, 12, 13])
_DOT = ~_class_bytes(_LINE_TERMS)


def _escape_set(ch: str) -> Optional[np.ndarray]:
    if ch == "d":
        return _D
    if ch == "D":
        return ~_D
    if ch == "w":
        return _W
    if ch == "W":
        return ~_W
    if ch == "s":
        return _S
    if ch == "S":
        return ~_S
    return None


_ESC_LIT = {"n": 10, "t": 9, "r": 13, "f": 12, "a": 7, "e": 27}


class _Parser:
    """Recursive-descent over the supported subset; builds NFA fragments
    (start, end) with eps/byte-set transitions."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> Tuple[int, int]:
        s, e = self.alternation()
        if self.i != len(self.p):
            raise Unsupported(f"unexpected '{self.peek()}'")
        return s, e

    def alternation(self) -> Tuple[int, int]:
        frags = [self.concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.concat())
        if len(frags) == 1:
            return frags[0]
        s = self.nfa.new_state()
        e = self.nfa.new_state()
        for fs, fe in frags:
            self.nfa.eps[s].append(fs)
            self.nfa.eps[fe].append(e)
        return s, e

    def concat(self) -> Tuple[int, int]:
        s = self.nfa.new_state()
        cur = s
        while self.peek() not in ("", "|", ")"):
            fs, fe = self.repeat()
            self.nfa.eps[cur].append(fs)
            cur = fe
        return s, cur

    def repeat(self) -> Tuple[int, int]:
        fs, fe = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            op = self.peek()
            if op == "{":
                save = self.i
                lo, hi = self._braces()
                if lo is None:
                    self.i = save
                    break
                fs, fe = self._repeat_range(fs, fe, lo, hi)
            else:
                self.take()
                if self.peek() in ("?", "+"):
                    raise Unsupported("lazy/possessive quantifier")
                if op == "*":
                    fs, fe = self._repeat_range(fs, fe, 0, None)
                elif op == "+":
                    fs, fe = self._repeat_range(fs, fe, 1, None)
                else:
                    fs, fe = self._repeat_range(fs, fe, 0, 1)
            # only one quantifier per atom (a** is a Java error anyway)
            break
        return fs, fe

    def _braces(self):
        assert self.take() == "{"
        num = ""
        while self.peek().isdigit():
            num += self.take()
        if not num:
            return None, None
        lo = int(num)
        hi = lo
        if self.peek() == ",":
            self.take()
            num2 = ""
            while self.peek().isdigit():
                num2 += self.take()
            hi = int(num2) if num2 else None
        if self.peek() != "}":
            return None, None
        self.take()
        if self.peek() in ("?", "+"):
            raise Unsupported("lazy/possessive quantifier")
        if lo > 64 or (hi is not None and (hi > 64 or hi < lo)):
            raise Unsupported("repetition count too large")
        return lo, hi

    def _clone(self, fs: int, fe: int) -> Tuple[int, int]:
        """Deep-copy an NFA fragment (for counted repetition)."""
        mapping: Dict[int, int] = {}
        stack = [fs]
        seen = {fs}
        order = []
        while stack:
            st = stack.pop()
            order.append(st)
            for t in self.nfa.eps[st]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
            for _, t in self.nfa.trans[st]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        for st in order:
            mapping[st] = self.nfa.new_state()
        for st in order:
            self.nfa.eps[mapping[st]] = [mapping[t]
                                         for t in self.nfa.eps[st]]
            self.nfa.trans[mapping[st]] = [
                (bs, mapping[t]) for bs, t in self.nfa.trans[st]]
        return mapping[fs], mapping[fe]

    def _repeat_range(self, fs, fe, lo, hi) -> Tuple[int, int]:
        s = self.nfa.new_state()
        cur = s
        for _ in range(lo):
            cs, ce = self._clone(fs, fe)
            self.nfa.eps[cur].append(cs)
            cur = ce
        e = self.nfa.new_state()
        if hi is None:  # unbounded tail: loop
            cs, ce = self._clone(fs, fe)
            self.nfa.eps[cur].append(cs)
            self.nfa.eps[cur].append(e)
            self.nfa.eps[ce].append(cs)
            self.nfa.eps[ce].append(e)
        else:
            for _ in range(hi - lo):
                cs, ce = self._clone(fs, fe)
                self.nfa.eps[cur].append(cs)
                self.nfa.eps[cur].append(e)
                cur = ce
            self.nfa.eps[cur].append(e)
        return s, e

    def _byte_frag(self, byteset: np.ndarray) -> Tuple[int, int]:
        s = self.nfa.new_state()
        e = self.nfa.new_state()
        self.nfa.trans[s].append((byteset, e))
        return s, e

    def atom(self) -> Tuple[int, int]:
        ch = self.peek()
        if ch == "(":
            self.take()
            if self.peek() == "?":
                self.take()
                if self.peek() != ":":
                    raise Unsupported("lookaround / named group")
                self.take()
            frag = self.alternation()
            if self.peek() != ")":
                raise Unsupported("unbalanced group")
            self.take()
            return frag
        if ch == "[":
            return self._byte_frag(self._char_class())
        if ch == ".":
            self.take()
            return self._byte_frag(_DOT)
        if ch == "\\":
            self.take()
            if self.i >= len(self.p):
                raise Unsupported("trailing backslash")
            nxt = self.take()
            cls = _escape_set(nxt)
            if cls is not None:
                return self._byte_frag(cls)
            if nxt in ("b", "B", "A", "Z", "z", "G"):
                raise Unsupported(f"anchor escape \\{nxt}")
            if nxt in ("p", "P"):
                raise Unsupported("\\p classes")
            if nxt.isdigit():
                raise Unsupported("backreference / octal escape")
            code = _ESC_LIT.get(nxt, None)
            if code is None:
                if ord(nxt) > 127:
                    raise Unsupported("non-ASCII pattern")
                if nxt.isalnum():
                    # \x41, \uFFFF, \cX, \Q...: Java-special escapes
                    raise Unsupported(f"escape \\{nxt}")
                code = ord(nxt)
            return self._byte_frag(_class_bytes([code]))
        if ch in ("^", "$"):
            raise Unsupported("mid-pattern anchor")
        if ch in ("*", "+", "?", "{", ")"):
            raise Unsupported(f"dangling '{ch}'")
        self.take()
        if ord(ch) > 127:
            raise Unsupported("non-ASCII pattern")
        return self._byte_frag(_class_bytes([ord(ch)]))

    def _char_class(self) -> np.ndarray:
        assert self.take() == "["
        neg = False
        if self.peek() == "^":
            neg = True
            self.take()
        mask = np.zeros(256, bool)
        first = True
        while True:
            ch = self.peek()
            if ch == "":
                raise Unsupported("unterminated class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                nxt = self.take()
                cls = _escape_set(nxt)
                if cls is not None:
                    mask |= cls
                    continue
                code = _ESC_LIT.get(nxt)
                if code is None:
                    if nxt.isalnum():
                        raise Unsupported(f"escape \\{nxt} in class")
                    code = ord(nxt)
                lo_c = code
            else:
                self.take()
                if ord(ch) > 127:
                    raise Unsupported("non-ASCII pattern")
                lo_c = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hc = self.take()
                if hc == "\\":
                    hc = self.take()
                    hi_c = _ESC_LIT.get(hc)
                    if hi_c is None:
                        if hc.isalnum():
                            raise Unsupported(f"escape \\{hc} in class")
                        hi_c = ord(hc)
                else:
                    if ord(hc) > 127:
                        raise Unsupported("non-ASCII pattern")
                    hi_c = ord(hc)
                if hi_c < lo_c:
                    raise Unsupported("bad class range")
                mask[lo_c:hi_c + 1] = True
            else:
                mask[lo_c] = True
        return ~mask if neg else mask


# ---------------------------------------------------------------------------
# NFA → DFA (subset construction)
# ---------------------------------------------------------------------------

def _eps_closure(nfa: _Nfa, states: FrozenSet[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


@dataclasses.dataclass
class DeviceRegex:
    table: np.ndarray          # int32 [S, 256]; state 0 = dead
    accept: np.ndarray         # bool [S]
    start_state: int
    anchored_start: bool
    anchored_end: bool
    has_alternation: bool
    matches_empty: bool
    pattern: str


def compile_regex(pattern: str) -> Optional[DeviceRegex]:
    """DFA-compile the pattern; None when outside the device subset."""
    try:
        if any(ord(c) > 127 for c in pattern):
            raise Unsupported("non-ASCII pattern")
        body = pattern
        anchored_start = body.startswith("^")
        if anchored_start:
            body = body[1:]
        anchored_end = body.endswith("$") and not body.endswith("\\$")
        if anchored_end:
            body = body[:-1]
        if anchored_start or anchored_end:
            # Java scopes ^/$ to the adjacent ALTERNATIVE, not the whole
            # pattern ('^a|b' == (^a)|(b)) — reject top-level '|'
            depth = 0
            in_class = False
            i = 0
            while i < len(body):
                ch = body[i]
                if ch == "\\":
                    i += 2
                    continue
                if in_class:
                    in_class = ch != "]"
                elif ch == "[":
                    in_class = True
                elif ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                elif ch == "|" and depth == 0:
                    raise Unsupported("anchor with top-level alternation")
                i += 1
        nfa = _Nfa()
        parser = _Parser(body, nfa)
        start, end = parser.parse()
        has_alt = "|" in body

        s0 = _eps_closure(nfa, frozenset([start]))
        states: Dict[FrozenSet[int], int] = {s0: 1}
        worklist = [s0]
        rows = {1: np.zeros(256, np.int32)}
        accepts = {1: end in s0}
        while worklist:
            cur = worklist.pop()
            ci = states[cur]
            row = rows[ci]
            # group target NFA-state sets per byte
            move: List[Optional[set]] = [None] * 256
            for s in cur:
                for byteset, t in nfa.trans[s]:
                    idxs = np.nonzero(byteset)[0]
                    for bval in idxs:
                        if move[bval] is None:
                            move[bval] = set()
                        move[bval].add(t)
            cache: Dict[FrozenSet[int], int] = {}
            for bval in range(256):
                if move[bval] is None:
                    continue
                key = frozenset(move[bval])
                di = cache.get(key)
                if di is None:
                    clo = _eps_closure(nfa, key)
                    di = states.get(clo)
                    if di is None:
                        if len(states) + 1 > MAX_DFA_STATES:
                            raise Unsupported("DFA too large")
                        di = len(states) + 1
                        states[clo] = di
                        rows[di] = np.zeros(256, np.int32)
                        accepts[di] = end in clo
                        worklist.append(clo)
                    cache[key] = di
                row[bval] = di
        nstates = len(states) + 1
        table = np.zeros((nstates, 256), np.int32)
        accept = np.zeros(nstates, bool)
        for di, row in rows.items():
            table[di] = row
        for di, a in accepts.items():
            accept[di] = a
        return DeviceRegex(table, accept, 1, anchored_start,
                           anchored_end, has_alt, bool(accept[1]),
                           pattern)
    except Unsupported:
        return None
    except RecursionError:
        return None


# ---------------------------------------------------------------------------
# Shared simulation (torch on the card, numpy on the CPU oracle; the same
# steps in the same order)
# ---------------------------------------------------------------------------

def device_tables(rx: DeviceRegex, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat transition table ``int32[S * 256]``, ``accept`` ``bool[S]``)
    on ``dev``, copied once per compiled pattern and device without
    waiting for the device (the host buffers are staged at once)."""
    dev = torch.device(dev)
    cache = rx.__dict__.setdefault("_device_tables", {})
    got = cache.get(dev)
    if got is None:
        flat = torch.from_numpy(
            np.ascontiguousarray(rx.table.reshape(-1), np.int32))
        acc = torch.from_numpy(np.ascontiguousarray(rx.accept, bool))
        got = (flat.to(dev, non_blocking=True),
               acc.to(dev, non_blocking=True))
        cache[dev] = got
    return got


def _end_ok_mask(data, lengths, rx: DeviceRegex, xp):
    """[B, W+1]: position p is a legal match END.

    Unanchored: any p <= len.  ``$``: p == len, or just before a final
    line terminator (Java Pattern ``$`` under find, non-UNIX_LINES):
    \\n, \\r\\n, \\r, and the Unicode terminators \\u0085 (UTF-8 C2 85)
    and \\u2028/\\u2029 (E2 80 A8|A9)."""
    b, w = data.shape
    if xp is np:
        pos = np.arange(w + 1, dtype=np.int32)[None, :]
        ln = lengths[:, None].astype(np.int32)
    else:
        pos = torch.arange(w + 1, dtype=torch.int32,
                           device=data.device)[None, :]
        ln = lengths[:, None].to(torch.int32)
    if not rx.anchored_end:
        return pos <= ln

    def byte_at(off):
        if xp is np:
            ix = np.clip(ln - off, 0, w - 1)
            return np.take_along_axis(data, ix.astype(np.int64), axis=1)
        ix = torch.clamp(ln - off, 0, w - 1)
        return torch.gather(data, 1, ix.long())

    at_end = pos == ln
    last_b = byte_at(1)
    last2_b = byte_at(2)
    last3_b = byte_at(3)
    is_nl = (last_b == 10) | (last_b == 13)
    crlf = (last2_b == 13) & (last_b == 10) & (ln >= 2)
    # Java's Dollar never matches BETWEEN \r and \n of a final CRLF
    before_final = (pos == ln - 1) & is_nl & (ln >= 1) & ~crlf
    before_crlf = (pos == ln - 2) & crlf
    nel = (last2_b == 0xC2) & (last_b == 0x85) & (ln >= 2)
    lsep = ((last3_b == 0xE2) & (last2_b == 0x80)
            & ((last_b == 0xA8) | (last_b == 0xA9)) & (ln >= 3))
    before_nel = (pos == ln - 2) & nel
    before_lsep = (pos == ln - 3) & lsep
    return (at_end | before_final | before_crlf
            | before_nel | before_lsep)


def match_lens(data, lengths, rx: DeviceRegex, xp):
    """Leftmost-longest match length per start -> int32 [B, W+1]
    (-1 = no match at that start; column W covers the empty match at
    end-of-string).  Starts beyond the row length are -1 except the
    end-of-string empty-match column."""
    b, w = data.shape
    end_ok = _end_ok_mask(data, lengths, rx, xp)
    if xp is np:
        flat = rx.table.reshape(-1).astype(np.int32)
        acc = rx.accept
        col = np.arange(w + 1, dtype=np.int32)[None, :]
        ln = lengths[:, None].astype(np.int32)
        valid_start = col <= ln
        if rx.anchored_start:
            valid_start = valid_start & (col == 0)
        state = np.full((b, w + 1), rx.start_state, np.int32)
        mlen = np.where(valid_start & rx.matches_empty & end_ok,
                        np.int32(0), np.int32(-1))
        for j in range(w):
            byte = data[:, j].astype(np.int32)[:, None]
            nxt = np.take(flat, state * 256 + byte)
            active = (col <= j) & (j < ln) & valid_start
            state = np.where(active, nxt, state)
            ok = np.take(acc, state) & active & end_ok[:, j + 1][:, None]
            mlen = np.where(ok, j + 1 - col, mlen)
        return mlen
    dev = data.device
    flat, acc = device_tables(rx, dev)
    col = torch.arange(w + 1, dtype=torch.int32, device=dev)[None, :]
    ln = lengths[:, None].to(torch.int32)
    valid_start = col <= ln
    if rx.anchored_start:
        valid_start = valid_start & (col == 0)
    state = torch.full((b, w + 1), rx.start_state, dtype=torch.int32,
                       device=dev)
    mlen = torch.where(valid_start & rx.matches_empty & end_ok, 0,
                       -1).to(torch.int32)
    # step j touches only the starts s <= j: the columns past j are
    # inactive in the numpy branch, so they keep their values
    for j in range(w):
        st = state[:, :j + 1]
        active = valid_start[:, :j + 1] & (j < ln)
        nxt = torch.take(flat, st.to(torch.int64) * 256
                         + data[:, j:j + 1].to(torch.int64))
        st = torch.where(active, nxt, st)
        state[:, :j + 1] = st
        ok = torch.take(acc, st.to(torch.int64)) & active \
            & end_ok[:, j + 1:j + 2]
        mlen[:, :j + 1] = torch.where(ok, j + 1 - col[:, :j + 1],
                                      mlen[:, :j + 1])
        del st, active, nxt, ok
    return mlen


def match_any(data, lengths, rx: DeviceRegex, xp):
    """Java Pattern.find existence per row -> bool [B]."""
    ml = match_lens(data, lengths, rx, xp)
    if xp is np:
        return np.any(ml >= 0, axis=1)
    return (ml >= 0).any(dim=1)


def extract_first(data, lengths, rx: DeviceRegex, xp):
    """First (leftmost, longest) match substring per row ->
    (matrix [B, W], lengths [B], matched bool [B]).  No match -> ''."""
    b, w = data.shape
    ml = match_lens(data, lengths, rx, xp)
    if xp is np:
        has = np.any(ml >= 0, axis=1)
        s0 = np.argmax(ml >= 0, axis=1).astype(np.int32)
        l0 = np.take_along_axis(ml, s0[:, None].astype(np.int64),
                                axis=1)[:, 0]
        l0 = np.where(has, l0, 0).astype(np.int32)
        k = np.arange(w, dtype=np.int32)[None, :]
        idx = np.clip(s0[:, None] + k, 0, w - 1)
        mat = np.take_along_axis(data, idx.astype(np.int64), axis=1)
        mat = np.where(k < l0[:, None], mat, 0).astype(data.dtype)
        return mat, l0, has
    hit = ml >= 0
    has = hit.any(dim=1)
    # argmax returns the first maximum: the leftmost match start
    s0 = torch.argmax(hit.to(torch.uint8), dim=1)
    l0 = torch.gather(ml, 1, s0[:, None])[:, 0]
    l0 = torch.where(has, l0, 0).to(torch.int32)
    k = torch.arange(w, device=data.device)[None, :]
    idx = torch.clamp(s0[:, None] + k, 0, w - 1)
    mat = torch.gather(data, 1, idx)
    mat = torch.where(k < l0[:, None], mat, 0).to(data.dtype)
    return mat, l0, has


def replace_all(data, lengths, rx: DeviceRegex, repl: bytes, xp):
    """Replace every non-overlapping leftmost match with the literal
    ``repl`` -> (matrix [B, Wout], lengths [B]), Wout = ``max(W, W *
    max(len(repl), 1))``.  Gated upstream: no alternation, no
    empty-matching patterns, no $ group refs."""
    b, w = data.shape
    r = len(repl)
    ml = match_lens(data, lengths, rx, xp)[:, :w]
    wout = max(w, w * max(r, 1))
    repl_arr = (np.frombuffer(repl, np.uint8) if r else
                np.zeros(1, np.uint8))
    if xp is np:
        ln = lengths[:, None].astype(np.int32)
        nxt = np.zeros((b,), np.int32)
        covered = np.zeros((b,), np.int32)
        starts = []
        consumed = []
        for j in range(w):
            here = (j >= nxt) & (ml[:, j] >= 1)
            end_j = (j + ml[:, j]).astype(np.int32)
            nxt = np.where(here, end_j, nxt)
            covered = np.maximum(covered, np.where(here, end_j, 0))
            starts.append(here)
            consumed.append(j < covered)
        S = np.stack(starts, axis=1)
        C = np.stack(consumed, axis=1)
        col = np.arange(w, dtype=np.int32)[None, :]
        keep = (~C) & (col < ln)
        e = (r * S.astype(np.int32) + keep.astype(np.int32))
        offs = np.cumsum(e, axis=1).astype(np.int32)
        total = offs[:, -1]
        k = np.arange(wout, dtype=np.int32)
        j_idx = np.empty((b, wout), np.int32)
        for i in range(b):
            j_idx[i] = np.searchsorted(offs[i], k, side="right")
        j_c = np.clip(j_idx, 0, w - 1).astype(np.int64)
        off_j = np.take_along_axis(offs, j_c, axis=1)
        e_j = np.take_along_axis(e, j_c, axis=1)
        oic = k[None, :] - (off_j - e_j)
        s_j = np.take_along_axis(S, j_c, axis=1)
        is_repl = s_j & (oic < max(r, 1)) & (r > 0)
        rb = np.take(repl_arr, np.clip(oic, 0, max(r - 1, 0)))
        db = np.take_along_axis(data, j_c, axis=1)
        out = np.where(is_repl, rb, db)
        valid = k[None, :] < total[:, None]
        return np.where(valid, out, 0).astype(data.dtype), total
    dev = data.device
    ln = lengths[:, None].to(torch.int32)
    nxt = torch.zeros((b,), dtype=torch.int32, device=dev)
    covered = torch.zeros((b,), dtype=torch.int32, device=dev)
    S = torch.empty((b, w), dtype=torch.bool, device=dev)
    C = torch.empty((b, w), dtype=torch.bool, device=dev)
    for j in range(w):
        mlj = ml[:, j]
        here = (nxt <= j) & (mlj >= 1)
        end_j = mlj + j
        nxt = torch.where(here, end_j, nxt)
        covered = torch.maximum(covered, torch.where(here, end_j, 0))
        S[:, j] = here
        C[:, j] = covered > j
    del ml
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    keep = ~C & (col < ln)
    e = r * S.to(torch.int32) + keep.to(torch.int32)
    offs = torch.cumsum(e, dim=1).to(torch.int32)
    total = offs[:, -1]
    k = torch.arange(wout, dtype=torch.int32, device=dev)
    j_idx = torch.searchsorted(offs, k.expand(b, -1).contiguous(),
                               side="right")
    j_c = torch.clamp(j_idx, 0, w - 1)
    off_j = torch.gather(offs, 1, j_c)
    e_j = torch.gather(e, 1, j_c)
    oic = k[None, :] - (off_j - e_j)
    s_j = torch.gather(S, 1, j_c)
    is_repl = s_j & (oic < max(r, 1)) & (r > 0)
    rv = torch.from_numpy(repl_arr.copy()).to(dev, non_blocking=True)
    rb = rv[torch.clamp(oic, 0, max(r - 1, 0)).long()]
    db = torch.gather(data, 1, j_c)
    out = torch.where(is_repl, rb, db)
    valid = k[None, :] < total[:, None]
    return torch.where(valid, out, 0).to(data.dtype), total
