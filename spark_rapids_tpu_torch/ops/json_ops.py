"""JSON expressions — ``get_json_object``, evaluated on the host.

[REF: sql-plugin/../GpuGetJsonObject + spark-rapids-jni
 get_json_object kernel]  The counterpart of the JAX package's
``ops/json_ops.py``, which evaluates it on the host too (its device JSON
scanner is planned, not written): the expression has no device lowering,
so the plan rewrite moves its operator to the CPU and reports why.

Semantics follow Spark's ``get_json_object``:

* malformed JSON input -> null (never an error, non-ANSI);
* the path starts with ``$``; ``.field``, ``['field']``,
  ``["field"]`` and ``[index]`` steps; a missing step -> null; an
  invalid path -> null for every row;
* a matched string returns its raw (unquoted) text; any other matched
  value its compact JSON serialization; a matched JSON null -> null.

As in the JAX package, numbers re-serialize through Python (``1.00``
becomes ``1.0``) and whitespace is normalized, where Spark copies the
raw tokens.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostCol
from spark_rapids_tpu_torch.ops.expressions import SIG_STRINGY, Expression

_STEP_RE = re.compile(
    r"\.(?P<field>[A-Za-z_][A-Za-z0-9_]*)"
    r"|\[\s*'(?P<qfield>[^']*)'\s*\]"
    r"|\[\s*\"(?P<dqfield>[^\"]*)\"\s*\]"
    r"|\[\s*(?P<index>\d+)\s*\]")


def parse_json_path(path: str) -> Optional[List[object]]:
    """``$.a.b[0]`` -> ['a', 'b', 0]; None when the path is invalid."""
    if not path or not path.startswith("$"):
        return None
    steps: List[object] = []
    pos = 1
    while pos < len(path):
        m = _STEP_RE.match(path, pos)
        if m is None:
            return None
        if m.group("field") is not None:
            steps.append(m.group("field"))
        elif m.group("qfield") is not None:
            steps.append(m.group("qfield"))
        elif m.group("dqfield") is not None:
            steps.append(m.group("dqfield"))
        else:
            steps.append(int(m.group("index")))
        pos = m.end()
    return steps


def extract_json_path(doc: str, steps: List[object]) -> Optional[str]:
    """The value at ``steps`` in the JSON text ``doc`` (see the module
    docstring), or None."""
    try:
        v = json.loads(doc)
    except (ValueError, TypeError):
        return None
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or s >= len(v):
                return None
        elif not isinstance(v, dict) or s not in v:
            return None
        v = v[s]
    if v is None:
        return None
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


@dataclasses.dataclass
class GetJsonObject(Expression):
    """get_json_object(json, path) -> string | null (host only)."""

    child: Expression
    path: str
    dtype: T.DataType = dataclasses.field(
        default_factory=lambda: T.StringT)

    type_sig = SIG_STRINGY
    input_sig = SIG_STRINGY

    @property
    def children(self):
        return (self.child,)

    def eval_cpu(self, batch: HostBatch) -> HostCol:
        c = self.child.eval_cpu(batch)
        steps = parse_json_path(self.path)
        n = len(c.data)
        out = np.full(n, "", dtype=object)
        validity = np.zeros(n, bool)
        if steps is not None:
            for i in range(n):
                if c.validity is not None and not c.validity[i]:
                    continue
                v = c.data[i]
                if isinstance(v, bytes):
                    v = v.decode("utf-8", "replace")
                r = extract_json_path(v, steps)
                if r is not None:
                    out[i] = r
                    validity[i] = True
        return HostCol(T.StringT, out, validity)

    def __str__(self):
        return f"get_json_object({self.child}, {self.path!r})"
