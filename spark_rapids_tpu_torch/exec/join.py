"""Join execs: the CPU oracle hash join and the device sort-merge join.

[REF: sql-plugin/../GpuShuffledHashJoinExec.scala, GpuBroadcastHashJoinExec]

The counterpart of the JAX package's ``exec/join.py``.  ``CpuJoinExec``
is its CPU oracle (a Python dict of the right side's keys, the residual
condition evaluated over the candidate pairs, numpy gathers); the plan
rewrite converts it through ``_tag_join``/``_convert_join`` and keeps it
on the CPU for what the device join lacks (a residual condition on an
outer, semi or anti join; mixed-width int keys on a right or full join;
key types of different families).  The device half:
the join keys encode as 64-bit limbs; the build (right) side is sorted
once; each left row finds its ``[lo, lo + m)`` range of matching build
rows — through ``kernels/hash_join.py::match_fused`` (one hash limb, the
CUDA kernel ``hash_pairs`` hashing both sides) on the ``cuda`` rung, or
the exact lexicographic bisection ``_lex_search`` on the ``jnp`` rung —
and the ranges expand into output rows with one host sync (the output
row count picks the output bucket).

Key encoding is canonical across sides: integral keys of any width
encode as 64-bit biased values, strings as byte matrices padded to the
shared width of both sides, float32 as orderable 32-bit values, float64
as a NaN flag plus a raw float limb.  Null and dead rows are excluded by
a leading exclusion flag, so null keys never match (Spark equi-join
semantics) but still surface in left and anti outputs.

Ported: inner, left, right, full, left_semi and left_anti joins and the
cross join (a join without equi keys: the in-core cross product,
``_cross``); a residual condition on an inner or cross join
(``_apply_condition``, a ``sel`` mask over the join output); right joins
run as left joins with the sides swapped (``_execute_swapped``); the
in-core path, the broadcast path, the run-time pick by live row counts
that streams the big side in bounded groups against a side that fits
(``_broadcast_streamed``, ``_semi_stream_right``), and the hash
sub-partition join of two oversized sides (``_sub_partition_join``).
Each device step reserves its working set with the memory arbiter
(``runtime/memory.py::transient``), so that a join can push scan-cache
entries to host; an in-core join whose reservation fails falls to the
sub-partition join.  A broadcast join streams partition by partition
of its other side and has that side's partitions; every other join
gathers all partitions of both sides into one.  Under
``spark.rapids.shuffle.mode=ICI`` on a mesh of more than one rank an
equi-join co-partitions both sides through ICI exchanges on its keys
and joins partition by partition (``partitioned``); with
``spark.sql.adaptive.enabled`` and a broadcast threshold the choice is
deferred to run time (``TpuAdaptiveJoinExec``: broadcast after
measuring the build side, else the two exchanges).  A multi-executor
run never broadcasts (a broadcast would capture one slice).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import kernels as KN
from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar import host as H
from spark_rapids_tpu_torch.columnar.column import (
    DeviceBatch, DeviceColumn, compact, empty_batch, round_up_pow2,
    slice_batch)
from spark_rapids_tpu_torch.exec.base import CpuExec, TpuExec
from spark_rapids_tpu_torch.exec.basic import (
    concat_device_batches, live_counts)
from spark_rapids_tpu_torch.exec.sort import _concat_host
from spark_rapids_tpu_torch.ops import decimal128 as D128
from spark_rapids_tpu_torch.ops import ordering as ORD
from spark_rapids_tpu_torch.ops.expressions import Expression, device_select
from spark_rapids_tpu_torch.ops.hashing import make_pid_fn
from spark_rapids_tpu_torch.parallel.shuffle import split_to_spillables
from spark_rapids_tpu_torch.runtime.memory import RetryOOM, get_manager


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _gather_list(child, partition=None) -> List[DeviceBatch]:
    """The child's batches (all partitions, or just one), compacted."""
    parts = (range(child.num_partitions()) if partition is None
             else [partition])
    return [compact(b) for p in parts for b in child.execute(p)]


def _gather_all(child, schema) -> H.HostBatch:
    """A CPU child's batches (all partitions) concatenated into one host
    batch (the host branch of the JAX package's ``_gather_all``)."""
    batches = [b for p in range(child.num_partitions())
               for b in child.execute(p)]
    if not batches:
        return H.HostBatch(schema, [
            H.HostCol(f.dtype,
                      np.array([], dtype=object)
                      if isinstance(f.dtype, (T.StringType, T.BinaryType))
                      else np.zeros(0, T.to_numpy_dtype(f.dtype)), None)
            for f in schema.fields])
    return _concat_host(schema, batches)


# ---------------------------------------------------------------------------
# CPU oracle
# ---------------------------------------------------------------------------

class CpuJoinExec(CpuExec):
    def __init__(self, join_type: str, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression], schema: T.StructType,
                 left: CpuExec, right: CpuExec, using: bool = True):
        super().__init__(schema, left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.using = using

    def node_string(self):
        cond = f" cond={self.condition}" if self.condition else ""
        return f"Join [{self.join_type}{cond}]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[H.HostBatch]:
        lb = _gather_all(self.children[0], self.children[0].schema)
        rb = _gather_all(self.children[1], self.children[1].schema)
        with self.timer():
            out = self._join(lb, rb)
        self.metric("numOutputRows").add(out.num_rows)
        self.metric("numOutputBatches").add(1)
        yield out

    def _join(self, lb: H.HostBatch, rb: H.HostBatch) -> H.HostBatch:
        nl, nr = lb.num_rows, rb.num_rows
        jt = self.join_type

        def key_tuple(cols, i):
            out = []
            for c in cols:
                if c.validity is not None and not c.validity[i]:
                    return None
                v = c.data[i]
                if isinstance(c.dtype, (T.FloatType, T.DoubleType)):
                    f = float(v)
                    v = "NaN" if np.isnan(f) else (0.0 if f == 0.0 else f)
                elif isinstance(c.dtype, (T.StringType, T.BinaryType)):
                    pass
                else:
                    v = int(v)
                out.append(v)
            return tuple(out)

        # 1. candidate pairs from equi keys (or the full cross space)
        if jt == "cross" or not self.left_keys:
            cl = np.repeat(np.arange(nl, dtype=np.int64), nr)
            cr = np.tile(np.arange(nr, dtype=np.int64), nl)
        else:
            lk = [e.eval_cpu(lb) for e in self.left_keys]
            rk = [e.eval_cpu(rb) for e in self.right_keys]
            index = {}
            for j in range(nr):
                k = key_tuple(rk, j)
                if k is not None:
                    index.setdefault(k, []).append(j)
            cl_list, cr_list = [], []
            for i in range(nl):
                k = key_tuple(lk, i)
                for j in (index.get(k, []) if k is not None else []):
                    cl_list.append(i)
                    cr_list.append(j)
            cl = np.array(cl_list, dtype=np.int64)
            cr = np.array(cr_list, dtype=np.int64)

        # 2. residual condition filters candidates (null -> drop), eval'd
        #    vectorized over the candidate pair batch in the
        #    left++right layout its refs were bound against
        if self.condition is not None and len(cl):
            pair_fields = tuple(self.children[0].schema.fields) + tuple(
                self.children[1].schema.fields)
            pair_cols = []
            for c in lb.columns:
                pair_cols.append(H.HostCol(
                    c.dtype, c.data[cl],
                    None if c.validity is None else c.validity[cl]))
            for c in rb.columns:
                pair_cols.append(H.HostCol(
                    c.dtype, c.data[cr],
                    None if c.validity is None else c.validity[cr]))
            pb = H.HostBatch(T.StructType(pair_fields), pair_cols)
            cv = self.condition.eval_cpu(pb)
            keep = cv.data.astype(bool)
            if cv.validity is not None:
                keep &= cv.validity
            cl, cr = cl[keep], cr[keep]

        # 3. join-type semantics over surviving pairs
        pairs: List[Tuple[int, int]] = []
        matched_l = np.zeros(nl, dtype=bool)
        matched_r = np.zeros(nr, dtype=bool)
        matched_l[cl] = True
        matched_r[cr] = True
        if jt == "left_semi":
            pairs = [(i, -1) for i in range(nl) if matched_l[i]]
        elif jt == "left_anti":
            pairs = [(i, -1) for i in range(nl) if not matched_l[i]]
        else:
            pairs = list(zip(cl.tolist(), cr.tolist()))
            if jt in ("left", "full"):
                # preserve left-row grouping order like the loop did
                merged: List[Tuple[int, int]] = []
                gi = 0
                for i in range(nl):
                    while gi < len(pairs) and pairs[gi][0] == i:
                        merged.append(pairs[gi])
                        gi += 1
                    if not matched_l[i]:
                        merged.append((i, -1))
                pairs = merged + pairs[gi:]
            if jt == "right":
                pairs = [(i, j) for (i, j) in pairs if j >= 0]
                pairs += [(-1, j) for j in range(nr) if not matched_r[j]]
            elif jt == "full":
                pairs += [(-1, j) for j in range(nr) if not matched_r[j]]

        lidx = np.array([p[0] for p in pairs], dtype=np.int64)
        ridx = np.array([p[1] for p in pairs], dtype=np.int64)
        return self._materialize(lb, rb, lidx, ridx)

    def _materialize(self, lb, rb, lidx, ridx) -> H.HostBatch:
        lkey_idx = [e.index for e in self.left_keys]
        rkey_idx = [e.index for e in self.right_keys]
        semi = self.join_type in ("left_semi", "left_anti")
        cross = self.join_type == "cross" or not self.using
        cols: List[H.HostCol] = []
        out_i = 0

        def gather(c: H.HostCol, idx) -> Tuple[np.ndarray, np.ndarray]:
            take = np.clip(idx, 0, max(len(c.data) - 1, 0))
            if len(c.data) == 0:
                data = np.zeros(len(idx), dtype=c.data.dtype)
            else:
                data = c.data[take]
            valid = (c.validity[take] if c.validity is not None
                     else np.ones(len(idx), bool)) if len(c.data) else \
                np.zeros(len(idx), bool)
            valid = valid & (idx >= 0)
            return data, valid

        if not cross:
            for ki in range(len(lkey_idx)):
                f = self.schema.fields[out_i]
                ld, lv = gather(lb.columns[lkey_idx[ki]], lidx)
                if self.join_type in ("right", "full"):
                    rd, rv = gather(rb.columns[rkey_idx[ki]], ridx)
                    data = np.where(lv, ld, rd)
                    valid = lv | rv
                else:
                    data, valid = ld, lv
                cols.append(H.HostCol(f.dtype, data,
                                      None if valid.all() else valid))
                out_i += 1
        for i in range(len(lb.columns)):
            if not cross and i in lkey_idx:
                continue
            f = self.schema.fields[out_i]
            data, valid = gather(lb.columns[i], lidx)
            cols.append(H.HostCol(f.dtype, data,
                                  None if valid.all() else valid))
            out_i += 1
        if not semi:
            for j in range(len(rb.columns)):
                if not cross and j in rkey_idx:
                    continue
                f = self.schema.fields[out_i]
                data, valid = gather(rb.columns[j], ridx)
                cols.append(H.HostCol(f.dtype, data,
                                      None if valid.all() else valid))
                out_i += 1
        return H.HostBatch(self.schema, cols)


def _row_groups(batches: List[DeviceBatch], cap: int
                ) -> List[List[DeviceBatch]]:
    """Batches in groups of at most ``cap`` rows of capacity.  A batch
    above the cap is cut into row slices first; the batches are
    compacted, so each slice keeps a contiguous live prefix."""
    groups: List[List[DeviceBatch]] = [[]]
    acc = 0
    for b in batches:
        chunks = ([b] if b.capacity <= cap else
                  [slice_batch(b, lo, cap)
                   for lo in range(0, b.capacity, cap)])
        for c in chunks:
            if groups[-1] and acc + c.capacity > cap:
                groups.append([])
                acc = 0
            groups[-1].append(c)
            acc += c.capacity
    return groups


# ---------------------------------------------------------------------------
# device search machinery
# ---------------------------------------------------------------------------

def _lex_search(sorted_limbs: List[torch.Tensor],
                query_limbs: List[torch.Tensor], side: str) -> torch.Tensor:
    """Vectorized lexicographic binary search — the exact rung.

    Per query row, the first index i of the sorted table with
    table[i] >= query (``side='left'``) or > query (``'right'``).  Limbs
    are int64 bit patterns compared as unsigned (``ORD.sortable``), or
    raw float64 limbs compared as floats.  Returns int64 indices.
    """
    if len(sorted_limbs) != len(query_limbs):
        raise ValueError("join key limb layouts differ between sides: "
                         f"{len(sorted_limbs)} vs {len(query_limbs)}")
    n = int(sorted_limbs[0].shape[0])
    nq = int(query_limbs[0].shape[0])
    dev = query_limbs[0].device
    table = [ORD.sortable(l) for l in sorted_limbs]
    query = [ORD.sortable(l) for l in query_limbs]
    lo = torch.zeros((nq,), dtype=torch.int64, device=dev)
    hi = torch.full((nq,), n, dtype=torch.int64, device=dev)
    steps = max(1, (max(n, 2) - 1).bit_length() + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        lt = torch.zeros((nq,), dtype=torch.bool, device=dev)
        eq = torch.ones((nq,), dtype=torch.bool, device=dev)
        for tl, ql in zip(table, query):
            tv = tl[midc]
            lt = lt | (eq & (tv < ql))
            eq = eq & (tv == ql)
        go_right = (lt | eq) if side == "right" else lt
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def _expand_counts(counts: torch.Tensor
                   ) -> Tuple[int, torch.Tensor, torch.Tensor, int]:
    """counts[B] -> (bucket, row_idx[bucket], offset[bucket], total).

    The ONE host sync of the join: the total match count picks the
    output bucket (a power of two); everything else stays on the device.
    """
    c64 = counts.to(torch.int64)
    cum = torch.cumsum(c64, 0)
    total = int(cum[-1]) if counts.shape[0] else 0
    bucket = round_up_pow2(max(total, 1))
    j = torch.arange(bucket, dtype=torch.int64, device=counts.device)
    i = torch.searchsorted(cum, j, right=True)
    i_c = i.clamp(0, max(counts.shape[0] - 1, 0))
    start = cum[i_c] - c64[i_c]
    return bucket, i_c, j - start, total


_INT_FAMILY = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


def _join_key_family(dt: T.DataType) -> str:
    """Key-compatibility class: members of the integral family may join
    each other (both canonicalize to 64 bits); others must match."""
    if isinstance(dt, _INT_FAMILY):
        return "int"
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        return "float" + str(32 if isinstance(dt, T.FloatType) else 64)
    return dt.simple_name


def _canonical_key_parts(c: DeviceColumn, str_width: int
                         ) -> List[ORD.Part]:
    """Equality-key parts whose layout depends only on the key's family
    (and the shared string width) — never on validity presence, the
    batch's own string width or the int width."""
    dt = c.dtype
    if isinstance(dt, (T.StringType, T.BinaryType)):
        data = c.data
        w = int(data.shape[1])
        if w < str_width:
            data = torch.nn.functional.pad(data, (0, str_width - w))
        return ORD._string_parts(data, c.lengths)
    if isinstance(dt, T.FloatType):
        # NaN canonicalized, -0.0 == 0.0 (Spark NormalizeFloatingNumbers)
        return [(ORD._f32_orderable_u32(c.data, normalize_zero=True), 32)]
    if isinstance(dt, T.DoubleType):
        # NaN rides a flag part, the value a raw float limb (NaN and -0.0
        # become +0.0 so that the sort and the search agree)
        isn = torch.isnan(c.data)
        val = torch.where(isn, 0.0, c.data)
        val = torch.where(val == 0.0, 0.0, val)
        return [ORD._flag_part(isn), (val, "f64")]
    if isinstance(dt, T.BooleanType):
        return [(c.data.to(torch.int64), 1)]
    if isinstance(dt, T.DecimalType) and c.data.dim() == 2:
        # decimal128: the biased hi limb, then the lo limb's bits
        return [ORD._int_part(c.data[:, 0], 64, True),
                (c.data[:, 1].contiguous(), 64)]
    # integral family, date, timestamp, decimal -> 64-bit biased encoding
    return [ORD._int_part(c.data.to(torch.int64), 64, True)]


def _key_parts(batch: DeviceBatch, keys: Sequence[Expression],
               str_widths: Sequence[int]
               ) -> Tuple[List[ORD.Part], torch.Tensor]:
    """(canonical equality key parts, has_null_key) of a batch's keys."""
    has_null = torch.zeros((batch.capacity,), dtype=torch.bool,
                           device=batch.device)
    parts: List[ORD.Part] = []
    for e, w in zip(keys, str_widths):
        c = e.eval(batch)
        if c.validity is not None:
            has_null = has_null | ~c.validity
        parts.extend(_canonical_key_parts(c, w))
    return parts, has_null


def _key_str_width(batch: DeviceBatch, e: Expression) -> int:
    """String width of a key expression's result on this batch: read off
    the batch for a column reference, else from the expression evaluated
    on a zero-row slice (shapes only, as the JAX package's
    ``eval_shape``)."""
    if not isinstance(e.dtype, (T.StringType, T.BinaryType)):
        return 0
    if hasattr(e, "index"):
        return int(batch.columns[e.index].data.shape[1])
    return int(e.eval(slice_batch(batch, 0, 0)).data.shape[1])


def _gather_col(c: DeviceColumn, idx: torch.Tensor,
                valid_out: torch.Tensor) -> DeviceColumn:
    g = c.gather(idx.clamp(0, c.capacity - 1))
    return DeviceColumn(c.dtype, g.data, g.valid_mask() & valid_out,
                        g.lengths, g.evalid)


# ---------------------------------------------------------------------------
# execs
# ---------------------------------------------------------------------------

class TpuBroadcastExchangeExec(TpuExec):
    """Gathers the (small) child into one batch once; the join reuses it.

    [REF: GpuBroadcastExchangeExec — in a single process the broadcast
    is the cached device batch itself]"""

    def __init__(self, child: TpuExec):
        super().__init__(child.schema, child)
        self._lock = threading.Lock()
        self._cached: Optional[DeviceBatch] = None

    def node_string(self):
        return "TpuBroadcastExchange"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        with self._lock:
            if self._cached is None:
                with self.timer("broadcastTime"):
                    self._cached = concat_device_batches(
                        self.schema, _gather_list(self.children[0]))
                self.metric("numOutputBatches").add(1)
        yield self._cached


class TpuSortMergeJoinExec(TpuExec):
    """[REF: GpuShuffledHashJoinExec — the same plan position, with the
    sort-merge algorithm; GpuBroadcastHashJoinExec when ``broadcast`` is
    set]

    ``broadcast`` names the side ("left"/"right") that is a
    ``TpuBroadcastExchangeExec``; ``partitioned`` says both sides are
    hash exchanges on the join keys (the adaptive join's shuffled plan),
    joined partition by partition, and ``skew_split`` (an
    ``AdaptivePolicy`` or None) then splits the stream side's hot
    partitions (``_skew_specs``); ``sub_partition_rows``
    (``spark.rapids.tpu.join.targetRows``) caps the rows of one in-core
    join; join outputs re-batch to ``out_batch_rows``
    (``spark.rapids.tpu.batchRows``).  ``backend`` is the kernel plane's
    rung for the match ranges.

    Metrics beyond the JAX package's (``streamedJoins``,
    ``subPartitionJoins``, ``partitionTime``): the port counts the groups
    of each side that streamed against the other
    (``streamedLeftGroups``, ``streamedRightGroups``), so that a run can
    tell which side stayed whole, and the sub-partitions of the hash
    split (``subPartitions``: k of the first split;
    ``subPartitionResplits``: the sum of k over the re-splits).
    """

    def __init__(self, join_type: str, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression], schema: T.StructType,
                 left: TpuExec, right: TpuExec, using: bool = True,
                 broadcast: Optional[str] = None,
                 sub_partition_rows: int = 1 << 18,
                 out_batch_rows: Optional[int] = None,
                 backend: str = "auto", partitioned: bool = False,
                 skew_split=None):
        super().__init__(schema, left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.using = using
        self.broadcast = broadcast
        self.sub_partition_rows = sub_partition_rows
        self.out_batch_rows = out_batch_rows
        self.backend = KN.resolve("join", backend)
        self.partitioned = partitioned
        self.skew_split = skew_split
        self._split_lock = threading.Lock()
        self._split_specs: Optional[List[Tuple[int, int, int]]] = None
        self._split_planned = False
        # a build partition replicated across a hot partition's slices
        # is gathered once and shared
        self._split_build_cache: dict = {}

    def node_string(self):
        part = " partitioned" if self.partitioned else ""
        bc = f" broadcast={self.broadcast}" if self.broadcast else ""
        cond = f" cond={self.condition}" if self.condition else ""
        return f"TpuSortMergeJoin [{self.join_type}{part}{bc}{cond}]"

    def num_partitions(self) -> int:
        # a broadcast join streams partition by partition of the other
        # side, a partitioned one pairs the exchanges' partitions (or the
        # skew plan's slices); any other join gathers both sides into one
        # partition
        if self.broadcast == "right":
            return self.children[0].num_partitions()
        if self.broadcast == "left":
            return self.children[1].num_partitions()
        if self.partitioned:
            specs = self._skew_specs()
            if specs is not None:
                return len(specs)
            return self.children[0].num_partitions()
        return 1

    def _skew_specs(self) -> Optional[List[Tuple[int, int, int]]]:
        """The adaptive skew-healing read plan of a partitioned join, or
        None for the 1:1 partition mapping.

        One ``(p, j, k)`` per output partition: slice j of k of the
        stream side's exchange partition p (k == 1 reads it whole).
        Hot partitions — by the exchange's recorded partition counts
        and the policy's skew threshold — split into rank-interleaved
        slices (``execute_split``), each joined against the build
        side's whole matching partition, so every stream row still sees
        all of its key's build rows: this spreads a SINGLE hot key, which
        the hash split (``_sub_partition_join``) cannot."""
        pol = self.skew_split
        if pol is None or not self.partitioned:
            return None
        lex = self.children[0]
        if not (hasattr(lex, "execute_split")
                and hasattr(lex, "aqe_partition_stats")):
            return None
        with self._split_lock:
            if self._split_planned:
                return self._split_specs
            self._split_planned = True
            from spark_rapids_tpu_torch import adaptive as AD
            from spark_rapids_tpu_torch.adaptive import replanner
            from spark_rapids_tpu_torch.runtime import stats as stats_mod
            st = stats_mod.current()
            rec = st.partition_counts(lex) if st is not None else None
            unit, counts = (rec if rec is not None
                            else lex.aqe_partition_stats())
            if unit != "rows":
                return None
            planned = replanner.plan_skew_reads(pol, self.join_type,
                                                counts)
            if planned is None:
                return None
            specs, detail = planned
            self.metric("skewSplitJoins").add(len(detail["partitions"]))
            AD.record_decision(self, "skew-split", **detail)
            self._split_specs = specs
            return specs

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        jt = self.join_type
        if jt == "right":
            yield from self._execute_swapped(partition)
            return
        l_list = r_list = None
        if self.broadcast == "right":
            lpart, rpart = partition, None
        elif self.broadcast == "left":
            lpart, rpart = None, partition
        elif self.partitioned:
            lpart = rpart = partition
            specs = self._skew_specs()
            if specs is not None:
                p, j, k = specs[partition]
                lpart = rpart = p
                if k > 1:
                    # a hot partition: a rank-interleaved stream slice
                    # joined against the replicated build partition
                    with self.timer("gatherTime"):
                        l_list = [compact(b) for b in
                                  self.children[0].execute_split(p, j, k)]
                        with self._split_lock:
                            r_cached = self._split_build_cache.get(p)
                            if r_cached is None:
                                r_cached = _gather_list(
                                    self.children[1], rpart)
                                self._split_build_cache[p] = r_cached
                        # a copy: the sub-partition path drains its
                        # input lists in place
                        r_list = list(r_cached)
        else:
            lpart = rpart = None
        if l_list is None:
            with self.timer("gatherTime"):
                l_list = _gather_list(self.children[0], lpart)
                r_list = _gather_list(self.children[1], rpart)
        # a streamed partition may hold no batch (an AQE read of a host
        # shuffle yields none for an empty range): its empty stand-in
        # goes on the other side's device
        dev = (l_list or r_list)[0].device if (l_list or r_list) else None
        nokey = jt == "cross" or not self.left_keys
        mgr = get_manager()
        total = (sum(b.nbytes() for b in l_list)
                 + sum(b.nbytes() for b in r_list))
        cap = self.sub_partition_rows
        l_counts = r_counts = side_live = None
        if cap and not nokey and not self.broadcast:
            # run-time strategy pick by LIVE rows (one device read for
            # both sides): a filtered side keeps its scan bucket but may
            # hold few live rows
            counts = live_counts(l_list + r_list)
            l_counts = counts[:len(l_list)]
            r_counts = counts[len(l_list):]
            l_live = sum(l_counts) or 1
            r_live = sum(r_counts) or 1
            side_live = max(l_live, r_live)
            if side_live > cap:
                # one side fits in-core: stream the other in bounded
                # groups against it (never for a full join, whose
                # unmatched right rows would repeat once per group)
                if (r_live <= cap
                        and jt in ("inner", "left", "left_semi",
                                   "left_anti")):
                    self.metric("streamedJoins").add(1)
                    yield from self._broadcast_streamed(
                        l_list, r_list, jt, mgr, side="right")
                    return
                if l_live <= cap and jt == "inner":
                    self.metric("streamedJoins").add(1)
                    yield from self._broadcast_streamed(
                        l_list, r_list, jt, mgr, side="left")
                    return
                if l_live <= cap and jt in ("left_semi", "left_anti"):
                    self.metric("streamedJoins").add(1)
                    yield from self._semi_stream_right(
                        l_list, l_counts, r_list, jt, mgr)
                    return
                # neither side fits: hash-split both
                self.metric("subPartitionJoins").add(1)
                yield from self._sub_partition_join(
                    l_list, r_list, jt, total, mgr, live_rows=side_live)
                return
        # a broadcast join's streamed side honors the row cap in bounded
        # groups (the broadcast side is capped by the byte threshold)
        if cap and not nokey and self.broadcast and sum(
                b.capacity for b in (l_list if self.broadcast == "right"
                                     else r_list)) > cap:
            yield from self._broadcast_streamed(l_list, r_list, jt, mgr)
            return
        try:
            # in-core: both sides and the expanded output live together
            with mgr.transient(2 * total):
                lb = self._concat(0, l_list, l_counts, dev)
                rb = self._concat(1, r_list, r_counts, dev)
                with self.timer():
                    if nokey:
                        cb, ctotal = self._cross(lb, rb)
                        outs = list(self._rebatch(
                            self._apply_condition(cb), ctotal))
                    else:
                        outs = list(self._merge_join(lb, rb, jt))
                yield from self._emit(outs)
                return
        except RetryOOM:
            if nokey:
                raise  # a cross product cannot hash-split
            self.metric("subPartitionJoins").add(1)
        yield from self._sub_partition_join(l_list, r_list, jt, total, mgr,
                                            live_rows=side_live)

    def _execute_swapped(self, partition: int) -> Iterator[DeviceBatch]:
        """right outer = left outer with the sides swapped, its columns
        remapped.  The inner node's strategy metrics are forwarded to
        this node with their sides named as this node's (the JAX package
        leaves them on the inner node, which no plan walk reaches)."""
        inner = TpuSortMergeJoinExec(
            "left", self.right_keys, self.left_keys, self.condition,
            self._swapped_schema(), self.children[1], self.children[0],
            using=self.using, sub_partition_rows=self.sub_partition_rows,
            out_batch_rows=self.out_batch_rows, backend=self.backend,
            partitioned=self.partitioned)
        n_lc = len(self.children[0].schema)
        n_rc = len(self.children[1].schema)
        if not self.using:
            # swapped output: all right ++ all left -> left ++ right
            order = ([n_rc + i for i in range(n_lc)]
                     + [i for i in range(n_rc)])
        else:
            nk = len(self.left_keys)
            lkey = [e.index for e in self.left_keys]
            rkey = [e.index for e in self.right_keys]
            n_l = len([i for i in range(n_lc) if i not in lkey])
            n_r = len([i for i in range(n_rc) if i not in rkey])
            # swapped output: [keys, right rest, left rest] -> [keys,
            # left rest, right rest]
            order = (list(range(nk))
                     + [nk + n_r + i for i in range(n_l)]
                     + [nk + i for i in range(n_r)])
        try:
            for b in inner.execute(partition):
                self.metric("numOutputBatches").add(1)
                yield DeviceBatch(self.schema,
                                  tuple(b.columns[i] for i in order), b.sel,
                                  compacted=b.compacted)
        finally:
            swap = {"streamedLeftGroups": "streamedRightGroups",
                    "streamedRightGroups": "streamedLeftGroups"}
            for k, m in inner.metrics.items():
                if k != "numOutputBatches":
                    self.metric(swap.get(k, k)).add(m.value)

    def _swapped_schema(self) -> T.StructType:
        if not self.using:
            return T.StructType(
                tuple(self.children[1].schema.fields)
                + tuple(self.children[0].schema.fields))
        nk = len(self.left_keys)
        rkey = [e.index for e in self.right_keys]
        lkey = [e.index for e in self.left_keys]
        rf = [f for i, f in enumerate(self.children[1].schema.fields)
              if i not in rkey]
        lf = [f for i, f in enumerate(self.children[0].schema.fields)
              if i not in lkey]
        return T.StructType(tuple(self.schema.fields[:nk]) + tuple(rf)
                            + tuple(lf))

    def _concat(self, side: int, batches, counts=None, device=None
                ) -> DeviceBatch:
        """One batch of a side's batches; an empty batch on ``device``
        when there are none (a sub-partition that received no row)."""
        schema = self.children[side].schema
        if not batches:
            return empty_batch(schema, device)
        return concat_device_batches(schema, batches, counts=counts)

    def _emit(self, outs: List[DeviceBatch]) -> Iterator[DeviceBatch]:
        for o in outs:
            self.metric("numOutputBatches").add(1)
            yield o

    def _broadcast_streamed(self, l_list, r_list, jt, mgr,
                            side: Optional[str] = None
                            ) -> Iterator[DeviceBatch]:
        """Join the streamed side in groups of at most the row cap
        against the whole other side.  Correct for inner/left/semi/anti
        with the right side whole, and for inner with the left side
        whole: each streamed row's output depends only on the whole
        side, so groups are independent.  ``side`` (the whole side)
        overrides ``self.broadcast`` for the run-time pick on plans
        without a broadcast."""
        side = side or self.broadcast
        stream = l_list if side == "right" else r_list
        groups = _row_groups(stream, self.sub_partition_rows)
        self.metric("streamedLeftGroups" if side == "right"
                    else "streamedRightGroups").add(len(groups))
        # the WHOLE side's schema is the one named by ``side``, not by
        # self.broadcast (the JAX package's fix for TPC-H q7)
        bc = self._concat(1 if side == "right" else 0,
                          r_list if side == "right" else l_list)
        for g in groups:
            gb = self._concat(0 if side == "right" else 1, g)
            lb, rb = (gb, bc) if side == "right" else (bc, gb)
            with mgr.transient(2 * (gb.nbytes() + bc.nbytes())):
                with self.timer():
                    outs = list(self._merge_join(lb, rb, jt))
                yield from self._emit(outs)

    def _semi_stream_right(self, l_list, l_counts, r_list, jt, mgr
                           ) -> Iterator[DeviceBatch]:
        """semi/anti with the LEFT side whole and an oversized RIGHT:
        stream the right side in bounded groups, OR-accumulating each
        left row's match flag.  A semi/anti verdict is "matched anywhere
        on the right", so group membership never changes it; null-key
        and dead left rows get m == 0 from every group."""
        lb = self._concat(0, l_list, l_counts)
        groups = _row_groups(r_list, self.sub_partition_rows)
        self.metric("streamedRightGroups").add(len(groups))
        matched = torch.zeros((lb.capacity,), dtype=torch.bool,
                              device=lb.device)
        for g in groups:
            rb = self._concat(1, g)
            with mgr.transient(2 * (lb.nbytes() + rb.nbytes())), \
                    self.timer():
                m, _, _, _ = self._match_ranges(lb, rb)
                matched = matched | (m > 0)
        keep = matched if jt == "left_semi" else ~matched
        out = lb.with_sel(lb.sel & keep)
        yield from self._emit(list(self._rebatch(self._project_semi(out),
                                                 out.capacity)))

    def _sub_partition_join(self, l_list, r_list, jt, total: int, mgr,
                            depth: int = 0,
                            live_rows: Optional[int] = None
                            ) -> Iterator[DeviceBatch]:
        """Two oversized sides: a recursive hash split [REF:
        GpuSubPartitionHashJoin].  Both sides re-hash on the join keys
        with a seed of their own per depth into k sub-partitions, each
        (batch x sub-partition) slice registers as a spillable, and each
        pair joins on its own: peak device memory is about one pair.
        Equal keys land in equal sub-partitions, so every join type's
        semantics hold per pair.

        k satisfies two ceilings, clamped to [2, 256]: memory (``total``
        bytes of both sides over a quarter of the arbiter's budget) and
        rows (the larger side's live rows, measured by the caller, or on
        a re-split its capacity, over ``join.targetRows``).  A pair
        still above the row cap re-splits with the next seed, up to
        depth 3 (a single hot key can never spread by key hash: past the
        cap the pair joins in-core).  Pairs whose output must be empty
        for the join type are skipped; a full join keeps every pair with
        rows on either side.  The split drains ``l_list`` and
        ``r_list``, so the inputs free as their slices are cut."""
        k_mem = -(-total // max(mgr.budget // 4, 1))
        side_cap = live_rows if live_rows else max(
            sum(b.capacity for b in l_list) or 1,
            sum(b.capacity for b in r_list) or 1)
        k_rows = (-(-side_cap // self.sub_partition_rows)
                  if self.sub_partition_rows else 1)
        k = max(2, min(256, max(k_mem, k_rows)))
        self.metric("subPartitions" if depth == 0
                    else "subPartitionResplits").add(k)
        canon = tuple(
            type(le.dtype) is not type(re.dtype)
            and isinstance(le.dtype, _INT_FAMILY)
            for le, re in zip(self.left_keys, self.right_keys))
        # not Spark's shuffle seed 42; one per depth, so that a skewed
        # sub-partition's keys spread again on the re-split
        sub_seed = 0x53504C54 + depth
        dev = (l_list or r_list)[0].device

        def split(batches, keys):
            pid_fn = make_pid_fn(keys, k, canon, sub_seed)
            return split_to_spillables(batches, lambda b, aux: pid_fn(b),
                                       k, mgr)

        with self.timer("partitionTime"):
            l_slices = split(l_list, self.left_keys)
            r_slices = split(r_list, self.right_keys)
        for lp, rp in zip(l_slices, r_slices):
            # inner/semi emit only matched left rows: an empty side means
            # an empty pair; left/anti must still emit a left side
            if ((jt in ("inner", "left_semi") and (not lp or not rp))
                    or (not lp and jt in ("left", "left_anti"))
                    or (not lp and not rp)):
                for sp in lp + rp:
                    sp.close()
                continue
            pair_bytes = (sum(sp.nbytes for sp in lp)
                          + sum(sp.nbytes for sp in rp))
            # capacity is read off the spillables (no restore); the
            # registrations stay open until the pair is done, so that
            # the arbiter keeps seeing (and can spill) its bytes
            if (self.sub_partition_rows and depth < 3
                    and max(sum(sp.capacity for sp in lp) or 1,
                            sum(sp.capacity for sp in rp) or 1)
                    > self.sub_partition_rows):
                yield from self._sub_partition_join(
                    [sp.get() for sp in lp], [sp.get() for sp in rp], jt,
                    pair_bytes, mgr, depth + 1)
                for sp in lp + rp:
                    sp.close()
                continue
            # clamped: one pair can exceed a tiny budget after padding
            with mgr.transient(min(2 * max(pair_bytes, 1), mgr.budget)):
                lb = self._concat(0, [sp.get() for sp in lp],
                                  [sp.live_rows for sp in lp], dev)
                rb = self._concat(1, [sp.get() for sp in rp],
                                  [sp.live_rows for sp in rp], dev)
                with self.timer():
                    outs = list(self._merge_join(lb, rb, jt))
                del lb, rb
                yield from self._emit(outs)
                for sp in lp + rp:
                    sp.close()

    def _cross(self, lb: DeviceBatch, rb: DeviceBatch
               ) -> Tuple[DeviceBatch, int]:
        """The in-core cross product of two compacted batches: output
        row j pairs left row j // nr with right row j % nr (one host read
        of both live counts picks the output bucket)."""
        nl, nr = torch.stack([lb.sel.sum(), rb.sel.sum()]).tolist()
        total = nl * nr
        bucket = round_up_pow2(max(total, 1))
        j = torch.arange(bucket, dtype=torch.int64, device=lb.device)
        l_idx = j // max(nr, 1)
        r_idx = j % max(nr, 1)
        out_live = j < total
        return self._materialize(lb, rb, l_idx, r_idx, out_live, out_live,
                                 out_live, "cross"), total

    def _apply_condition(self, batch: DeviceBatch) -> DeviceBatch:
        """The residual condition as a ``sel`` mask over the join output
        (its references are bound against left ++ right, this node's
        schema); a null condition drops the row.  The masked batch is
        no longer compacted."""
        if self.condition is None:
            return batch
        c = self.condition.eval(batch)
        keep = c.data.to(torch.bool)
        if c.validity is not None:
            keep = keep & c.validity
        return batch.with_sel(batch.sel & keep)

    # -- core ---------------------------------------------------------------
    def _match_ranges(self, lb: DeviceBatch, rb: DeviceBatch):
        """``(m, lo, perm, l_null)``: per left row, its match count and
        the position of its first match in the right side sorted by
        ``perm``.  The ``cuda`` rung runs ``kernels/hash_join.py::
        match_fused`` and descends to the exact rung on a detected
        64-bit collision; within a match range both rungs enumerate the
        same right rows in the same (original-index) order, so
        ``_merge_join``'s output is identical."""
        left_keys, right_keys = self.left_keys, self.right_keys
        # shared string width per key pair: the two sides' canonical
        # layouts must match even when their paddings differ
        widths = tuple(
            max(_key_str_width(lb, le), _key_str_width(rb, re))
            for le, re in zip(left_keys, right_keys))

        def run(backend):
            r_parts, r_null = _key_parts(rb, right_keys, widths)
            r_excl = (~rb.sel) | r_null
            l_parts, l_null = _key_parts(lb, left_keys, widths)
            l_live = lb.sel & ~l_null
            if backend != "jnp":
                from spark_rapids_tpu_torch.kernels import hash_join as KNJ
                res = KNJ.match_fused(
                    ORD.fuse_parts(l_parts), ORD.fuse_parts(r_parts),
                    r_excl, use_kernel=(backend == "cuda"))
                if res is not None:
                    m, lo, perm, okf = res
                    m = torch.where(l_live, m, 0)
                    return (m, lo, perm, l_null), okf
                # unhashable keys (raw-f64 limb): the exact rung runs
                # inside this rung; ok=None -> dispatch counts "jnp"
            sorted_limbs, perm = ORD.sort_by_keys(ORD.fuse_parts(
                [ORD._flag_part(r_excl)] + r_parts))
            # canonical encoding -> identical fused limb layout on both
            # sides, compared limb for limb
            q_zero = ORD._flag_part(torch.zeros(
                (lb.capacity,), dtype=torch.bool, device=lb.device))
            q_limbs = ORD.fuse_parts([q_zero] + l_parts)
            lo = _lex_search(sorted_limbs, q_limbs, "left")
            hi = _lex_search(sorted_limbs, q_limbs, "right")
            m = torch.where(l_live, hi - lo, 0)
            return (m, lo, perm, l_null), None

        return KN.dispatch("join", self.backend,
                           lambda be: (lambda: run(be)), node=self)

    def _merge_join(self, lb: DeviceBatch, rb: DeviceBatch, jt: str
                    ) -> Iterator[DeviceBatch]:
        m, lo, perm, _ = self._match_ranges(lb, rb)
        if jt in ("left_semi", "left_anti"):
            keep = (m > 0) if jt == "left_semi" else (m == 0)
            out = lb.with_sel(lb.sel & keep)
            yield from self._rebatch(self._project_semi(out),
                                     out.capacity)
            return
        counts = m
        if jt in ("left", "full"):
            counts = torch.where(lb.sel & (m == 0), 1, m)
        bucket, l_idx, off, total = _expand_counts(counts)
        matched = m[l_idx] > 0
        r_sorted_pos = lo[l_idx] + off
        r_idx = perm[r_sorted_pos.clamp(0, rb.capacity - 1)]
        out_live = torch.arange(bucket, device=lb.device) < total
        l_valid = out_live
        r_valid = out_live & matched
        if jt == "full":
            # append the unmatched live right rows after the left-join
            # block (one more host read: their count)
            hit = torch.zeros((rb.capacity + 1,), dtype=torch.bool,
                              device=rb.device)
            hit[torch.where(r_valid, r_idx, rb.capacity)] = True
            r_extra = torch.nonzero(rb.sel & ~hit[:rb.capacity]).flatten()
            n_extra = int(r_extra.numel())
            full_bucket = round_up_pow2(max(total + n_extra, 1))
            pad = full_bucket - bucket
            if pad > 0:
                def grow(x):
                    return torch.nn.functional.pad(x, (0, pad))
                l_idx, r_idx = grow(l_idx), grow(r_idx)
                l_valid, r_valid = grow(l_valid), grow(r_valid)
                out_live = grow(out_live)
            j = torch.arange(full_bucket, device=lb.device)
            in_extra = (j >= total) & (j < total + n_extra)
            if n_extra:
                r_idx = torch.where(
                    in_extra, r_extra[(j - total).clamp(0, n_extra - 1)],
                    r_idx)
            l_valid = l_valid & ~in_extra
            r_valid = r_valid | in_extra
            out_live = out_live | in_extra
            total += n_extra
        out = self._materialize(lb, rb, l_idx, r_idx, l_valid, r_valid,
                                out_live, jt)
        if jt == "inner":
            out = self._apply_condition(out)
        yield from self._rebatch(out, total)

    def _rebatch(self, out: DeviceBatch, total: int
                 ) -> Iterator[DeviceBatch]:
        """Slice an expanded join output into ``out_batch_rows`` chunks
        (views); all-dead tail chunks are skipped via the host-known
        ``total``.  Buckets are powers of two, so a power-of-two chunk
        divides the capacity."""
        cap = self.out_batch_rows
        if not cap or out.capacity <= cap:
            yield out
            return
        cap = 1 << (int(cap).bit_length() - 1)
        for i in range(max(1, -(-int(total) // cap))):
            yield slice_batch(out, i * cap, cap)

    def _project_semi(self, lb: DeviceBatch) -> DeviceBatch:
        """semi/anti output: [keys, left-rest] for USING joins, the left
        side's own order for expression joins."""
        if not self.using:
            return DeviceBatch(self.schema, lb.columns, lb.sel)
        lkey = [e.index for e in self.left_keys]
        order = lkey + [i for i in range(len(lb.columns)) if i not in lkey]
        return DeviceBatch(self.schema, tuple(lb.columns[i] for i in order),
                           lb.sel)

    def _materialize(self, lb, rb, l_idx, r_idx, l_valid, r_valid,
                     out_live, jt) -> DeviceBatch:
        """Gather the output columns: for USING joins the key columns
        once (from the left; a full join coalesces them with the right
        side's, padding string keys to the wider side) then the left and
        right non-key columns; for expression and cross joins all left
        then all right columns.  Live rows are a prefix (``out_live``),
        so the batch is compacted."""
        lkey = [e.index for e in self.left_keys]
        rkey = [e.index for e in self.right_keys]
        using = self.using and jt != "cross"
        cols: List[DeviceColumn] = []
        if using:
            for ki, rki in zip(lkey, rkey):
                lc = _gather_col(lb.columns[ki], l_idx, l_valid)
                if jt == "full":
                    rc = _gather_col(rb.columns[rki], r_idx, r_valid)
                    lv = lc.valid_mask()
                    both = device_select(lv, lc, rc, lc.dtype)
                    lc = DeviceColumn(lc.dtype, both.data,
                                      lv | rc.valid_mask(), both.lengths)
                cols.append(lc)
        for i, c in enumerate(lb.columns):
            if not (using and i in lkey):
                cols.append(_gather_col(c, l_idx, l_valid))
        for j, c in enumerate(rb.columns):
            if not (using and j in rkey):
                cols.append(_gather_col(c, r_idx, r_valid))
        return DeviceBatch(self.schema, tuple(cols), out_live,
                           compacted=True)


# ---------------------------------------------------------------------------
# The plan rewrite's rule for joins
# ---------------------------------------------------------------------------

class _ReplayExec(TpuExec):
    """Serves already-materialized device batches (the stage-result
    handoff: a measured side re-enters the next plan step without
    re-executing its subtree)."""

    def __init__(self, schema, batches: List[DeviceBatch]):
        super().__init__(schema)
        self._batches = batches

    def node_string(self):
        return f"Replay[{len(self._batches)} batches]"

    def num_partitions(self) -> int:
        return 1

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        yield from self._batches


class TpuAdaptiveJoinExec(TpuExec):
    """AQE broadcast-after-measure over ICI exchanges [REF:
    GpuCustomShuffleReaderExec + Spark AQE's DynamicJoinSelection]: the
    planner could not prove the build side small (filters forward
    upper-bound estimates), so the join defers the strategy choice to
    RUN TIME.  The build side materializes once at the stage boundary;
    if its measured live bytes fit the broadcast threshold, the planned
    {exchange both sides -> partitioned join} collapses to a broadcast
    join (no all_to_all at all); otherwise the measured batches replay
    into the planned exchange, so nothing executes twice."""

    def __init__(self, join_type: str, left_keys, right_keys, condition,
                 schema, left: TpuExec, right: TpuExec, threshold: int,
                 canon_int64, using: bool, sub_partition_rows: int,
                 out_batch_rows, backend: str, device,
                 exchange_opts: Optional[dict] = None):
        super().__init__(schema, left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.threshold = int(threshold)
        self.canon_int64 = tuple(canon_int64)
        self.using = using
        self.sub_partition_rows = sub_partition_rows
        self.out_batch_rows = out_batch_rows
        self.backend = backend
        self.device = device
        # the runtime decision happens long after conversion: the
        # conf-derived exchange kwargs ride on the node
        self._exchange_opts = dict(exchange_opts or {})
        from spark_rapids_tpu_torch.parallel.mesh import make_mesh
        self.mesh = make_mesh(device=device)
        self._lock = threading.Lock()
        self._inner: Optional[TpuSortMergeJoinExec] = None
        self._mode: Optional[str] = None

    def node_string(self):
        mode = self._mode or "undecided"
        return (f"TpuAdaptiveJoin [{self.join_type} "
                f"runtime={mode} thresh={self.threshold}]")

    def num_partitions(self) -> int:
        return self.mesh.size

    def _decide(self):
        with self._lock:
            if self._inner is not None:
                return
            from spark_rapids_tpu_torch import adaptive as AD
            from spark_rapids_tpu_torch.exec.distributed import (
                TpuIciShuffleExchangeExec)
            with self.timer("measureTime"):
                r_list = _gather_list(self.children[1])
                # LIVE bytes, not pow-2 bucket capacity: a filtered
                # side keeps its input bucket but holds few live rows
                counts = live_counts(r_list)
            rbytes = sum(
                n * max(1, b.nbytes() // max(b.capacity, 1))
                for n, b in zip(counts, r_list))
            replay = _ReplayExec(self.children[1].schema, r_list)
            common = dict(using=self.using,
                          sub_partition_rows=self.sub_partition_rows,
                          out_batch_rows=self.out_batch_rows,
                          backend=self.backend)
            if rbytes <= self.threshold:
                self.metric("adaptiveBroadcastJoins").add(1)
                self._mode = "broadcast"
                self._inner = TpuSortMergeJoinExec(
                    self.join_type, self.left_keys, self.right_keys,
                    self.condition, self.schema, self.children[0],
                    TpuBroadcastExchangeExec(replay), broadcast="right",
                    **common)
            else:
                self.metric("adaptiveShuffledJoins").add(1)
                self._mode = "shuffled"
                lex = TpuIciShuffleExchangeExec(
                    self.children[0], self.left_keys, mesh=self.mesh,
                    canon_int64=self.canon_int64, **self._exchange_opts)
                rex = TpuIciShuffleExchangeExec(
                    replay, self.right_keys, mesh=self.mesh,
                    canon_int64=self.canon_int64, **self._exchange_opts)
                self._inner = TpuSortMergeJoinExec(
                    self.join_type, self.left_keys, self.right_keys,
                    self.condition, self.schema, lex, rex,
                    partitioned=True, **common)
            # the subtree built here is invisible to the plan walk:
            # decisions made inside it surface on this node
            self._inner._decision_owner = self
            AD.record_decision(self, self._mode, build_bytes=rbytes,
                               threshold=self.threshold,
                               source="measured")

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        self._decide()
        d = self.num_partitions()
        if self._mode == "shuffled":
            yield from self._inner.execute(partition)
            return
        # broadcast: stream-side partitions strided over the adaptive
        # node's fixed partition count
        n_lp = self._inner.num_partitions()
        for lp in range(partition, n_lp, d):
            yield from self._inner.execute(lp)


class TpuAdaptiveLocalJoinExec(TpuExec):
    """Single-process adaptive join — the adaptive plane's join strategy
    and skew-split decisions applied at a stage boundary (the JAX
    package's ``TpuAdaptiveLocalJoinExec``).

    The planner could not prove the build side small (the static
    broadcast in ``_convert_join`` would have fired), so the strategy
    defers to run time:

    * **warm** — the profile store already holds a measured build-side
      size for this join's subtree signature (``adaptive.historyPath``):
      decide from history, execute nothing early;
    * **cold** — materialize the build side once off its own pump,
      decide from its measured LIVE bytes, and replay the batches into
      whichever plan wins (nothing executes twice).

    Broadcast drops the exchange entirely; shuffled co-partitions both
    sides through in-process hash exchanges and hands the policy to the
    partitioned join, so recorded partition skew splits hot stream
    partitions (``TpuSortMergeJoinExec._skew_specs``)."""

    def __init__(self, join_type: str, left_keys, right_keys, condition,
                 schema, left: TpuExec, right: TpuExec, policy,
                 nparts: int, hash_ok: bool, using: bool,
                 sub_partition_rows: int, out_batch_rows, backend: str,
                 device):
        super().__init__(schema, left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.policy = policy
        self.nparts = int(nparts)
        # mixed-width int key pairs hash differently per side through
        # the plain hash exchange: those plans may flip to broadcast but
        # never to shuffled
        self.hash_ok = bool(hash_ok)
        self.using = using
        self.sub_partition_rows = sub_partition_rows
        self.out_batch_rows = out_batch_rows
        self.backend = backend
        self.device = device
        self._lock = threading.Lock()
        self._inner: Optional[TpuSortMergeJoinExec] = None
        self._mode: Optional[str] = None

    def node_string(self):
        mode = self._mode or "undecided"
        return (f"TpuAdaptiveLocalJoin [{self.join_type} runtime={mode} "
                f"thresh={self.policy.broadcast_threshold}]")

    def num_partitions(self) -> int:
        self._decide()
        return self._inner.num_partitions()

    def _decide(self):
        with self._lock:
            if self._inner is not None:
                return
            from spark_rapids_tpu_torch import adaptive as AD
            from spark_rapids_tpu_torch.adaptive import cost_model
            from spark_rapids_tpu_torch.adaptive import replanner
            from spark_rapids_tpu_torch.exec.exchange import (
                TpuShuffleExchangeExec)
            pol = self.policy
            sig = cost_model.subtree_signature(self.children[1])
            r_list = None
            decided = replanner.decide_join_from_history(pol, sig)
            if (decided is None and pol.wants_join
                    and pol.broadcast_threshold > 0):
                # cold query: measure the build side off its own pump.
                # LIVE bytes, not bucket capacity (a filtered side keeps
                # its scan bucket but holds few live rows)
                with self.timer("measureTime"):
                    r_list = _gather_list(self.children[1])
                    counts = live_counts(r_list)
                rbytes = sum(
                    n * max(1, b.nbytes() // max(b.capacity, 1))
                    for n, b in zip(counts, r_list))
                decided = replanner.decide_join_from_measurement(
                    pol, sig, rbytes)
            if decided is None:
                # join strategy gated off: keep the shuffled plan shape
                # (skew splitting is the remaining decision)
                decided = ("shuffled",
                           {"threshold": pol.broadcast_threshold,
                            "build_sig": sig, "source": "conf"})
            strategy, detail = decided
            build = (_ReplayExec(self.children[1].schema, r_list)
                     if r_list is not None else self.children[1])
            common = dict(using=self.using,
                          sub_partition_rows=self.sub_partition_rows,
                          out_batch_rows=self.out_batch_rows,
                          backend=self.backend)
            if strategy == "broadcast":
                self.metric("adaptiveBroadcastJoins").add(1)
                inner = TpuSortMergeJoinExec(
                    self.join_type, self.left_keys, self.right_keys,
                    self.condition, self.schema, self.children[0],
                    TpuBroadcastExchangeExec(build), broadcast="right",
                    **common)
            elif self.hash_ok:
                self.metric("adaptiveShuffledJoins").add(1)
                lex = TpuShuffleExchangeExec(self.children[0],
                                             self.nparts, self.left_keys,
                                             device=self.device)
                rex = TpuShuffleExchangeExec(build, self.nparts,
                                             self.right_keys,
                                             device=self.device)
                inner = TpuSortMergeJoinExec(
                    self.join_type, self.left_keys, self.right_keys,
                    self.condition, self.schema, lex, rex,
                    partitioned=True,
                    skew_split=pol if pol.wants_skew else None, **common)
            else:
                self.metric("adaptiveShuffledJoins").add(1)
                inner = TpuSortMergeJoinExec(
                    self.join_type, self.left_keys, self.right_keys,
                    self.condition, self.schema, self.children[0],
                    build, **common)
            # the subtree built here is invisible to the plan walk:
            # decisions made inside it surface on this node
            inner._decision_owner = self
            self._mode = strategy
            self._inner = inner
            AD.record_decision(self, strategy, **detail)

    def execute(self, partition: int) -> Iterator[DeviceBatch]:
        self._decide()
        yield from self._inner.execute(partition)


def _tag_join(meta):
    """The JAX package's ``_tag_join``: what keeps a join on the CPU."""
    from spark_rapids_tpu_torch.plan.overrides import tag_expression
    cpu = meta.cpu
    if cpu.condition is not None:
        if cpu.join_type not in ("inner", "cross"):
            meta.will_not_work(
                f"residual join conditions on {cpu.join_type} joins not "
                "yet on device (inner/cross only)")
        else:
            tag_expression(cpu.condition, meta)
    for le, re in zip(cpu.left_keys, cpu.right_keys):
        if D128.is128(le.dtype) and cpu.join_type in ("right", "full"):
            meta.will_not_work(
                "decimal128 join keys on right/full joins not yet on "
                "device (key-column coalesce lacks a 2-lane select)")
        lf, rf = _join_key_family(le.dtype), _join_key_family(re.dtype)
        if lf != rf:
            meta.will_not_work(
                f"join key type mismatch: {le.dtype.simple_name} vs "
                f"{re.dtype.simple_name} (no implicit cast inserted)")
        elif (type(le.dtype) is not type(re.dtype)
              and cpu.join_type in ("right", "full")):
            # right/full coalesce the two key columns into one output
            # column typed after the left key — mixed int widths would
            # smuggle int64 data under an int32 schema
            meta.will_not_work(
                "mixed-width int join keys not supported for "
                f"{cpu.join_type} joins (output key column would mix "
                f"{le.dtype.simple_name} and {re.dtype.simple_name})")
    for e in list(cpu.left_keys) + list(cpu.right_keys):
        tag_expression(e, meta)


def _convert_join(cpu, ch, conf, device):
    """The JAX package's ``_convert_join``: broadcast the small side when
    its estimate fits ``autoBroadcastJoinThreshold`` (never in a
    multi-executor run); under ICI co-partition both sides through ICI
    exchanges (or defer to ``TpuAdaptiveJoinExec``); under the adaptive
    plane an equi-join it may stream defers the strategy to run time
    (``TpuAdaptiveLocalJoinExec``); else a sort-merge join that picks
    its strategy from live row counts at run time."""
    from spark_rapids_tpu_torch.exec.distributed import ici_active
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    jt = cpu.join_type
    common = dict(using=cpu.using,
                  sub_partition_rows=conf.get(C.JOIN_TARGET_ROWS),
                  out_batch_rows=conf.batch_rows,
                  backend=conf.kernel_backend)
    # multi-executor: scans are executor-sliced, so a broadcast gather
    # would capture only this process's slice — joins must co-partition
    # through the ICI exchange instead
    multiproc = get_executor() is not None
    thresh = conf.get(C.BROADCAST_THRESHOLD)
    if thresh and thresh > 0 and not multiproc:
        rsize = cpu.children[1].estimated_size_bytes()
        lsize = cpu.children[0].estimated_size_bytes()
        if (rsize is not None and rsize <= thresh
                and jt in ("inner", "left", "left_semi", "left_anti",
                           "cross")):
            return TpuSortMergeJoinExec(
                jt, cpu.left_keys, cpu.right_keys, cpu.condition,
                cpu.schema, ch[0], TpuBroadcastExchangeExec(ch[1]),
                broadcast="right", **common)
        if lsize is not None and lsize <= thresh and jt == "inner":
            return TpuSortMergeJoinExec(
                jt, cpu.left_keys, cpu.right_keys, cpu.condition,
                cpu.schema, TpuBroadcastExchangeExec(ch[0]), ch[1],
                broadcast="left", **common)
    if ici_active(conf, device) and jt != "cross" and cpu.left_keys:
        # distributed: co-partition both sides through the ICI exchange
        # on the key hash, then join partition by partition (the
        # shuffled-hash-join plan shape [REF: GpuShuffledHashJoinExec])
        from spark_rapids_tpu_torch.exec.distributed import (
            TpuIciShuffleExchangeExec, exchange_opts)
        # both exchanges must agree on pids: widen int-family keys to 64
        # bits whenever the pair's widths differ
        canon = tuple(
            type(le.dtype) is not type(re.dtype)
            and isinstance(le.dtype, _INT_FAMILY)
            for le, re in zip(cpu.left_keys, cpu.right_keys))
        opts = exchange_opts(conf)
        if (conf.get(C.ADAPTIVE_ENABLED) and thresh and thresh > 0
                and not multiproc
                and jt in ("inner", "left", "left_semi", "left_anti")):
            # the planner could not prove the build side small (else
            # the static broadcast above fired) — defer to run time
            return TpuAdaptiveJoinExec(
                jt, cpu.left_keys, cpu.right_keys, cpu.condition,
                cpu.schema, ch[0], ch[1], thresh, canon, cpu.using,
                common["sub_partition_rows"], common["out_batch_rows"],
                common["backend"], device, exchange_opts=opts)
        lex = TpuIciShuffleExchangeExec(ch[0], cpu.left_keys,
                                       canon_int64=canon, device=device,
                                       **opts)
        rex = TpuIciShuffleExchangeExec(ch[1], cpu.right_keys,
                                       canon_int64=canon, device=device,
                                       **opts)
        return TpuSortMergeJoinExec(jt, cpu.left_keys, cpu.right_keys,
                                    cpu.condition, cpu.schema, lex, rex,
                                    partitioned=True, **common)
    if (not multiproc and cpu.left_keys
            and jt in ("inner", "left", "left_semi", "left_anti")):
        # single-process adaptive plane: defer broadcast-vs-shuffled to
        # the observed build cardinality and heal recorded partition skew
        from spark_rapids_tpu_torch import adaptive as AD
        pol = AD.policy_from_conf(conf)
        if pol.enabled and (pol.wants_join or pol.wants_skew):
            hash_ok = all(
                type(le.dtype) is type(re.dtype)
                for le, re in zip(cpu.left_keys, cpu.right_keys))
            return TpuAdaptiveLocalJoinExec(
                jt, cpu.left_keys, cpu.right_keys, cpu.condition,
                cpu.schema, ch[0], ch[1], pol,
                conf.get(C.SHUFFLE_PARTITIONS), hash_ok, cpu.using,
                common["sub_partition_rows"], common["out_batch_rows"],
                common["backend"], device)
    return TpuSortMergeJoinExec(
        jt, cpu.left_keys, cpu.right_keys, cpu.condition, cpu.schema,
        ch[0], ch[1], **common)
