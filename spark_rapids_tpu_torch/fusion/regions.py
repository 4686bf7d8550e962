"""Region selection: greedy maximal chains of fusable map operators.

The counterpart of the JAX package's ``fusion/regions.py``.  The pass
runs on the CONVERTED plan (after the exec rules, the transitions and
the coalesce pass), so every surviving node is what would execute
unfused; each member's ``plan_signature`` is computed at its pre-fusion
tree path, the signature an unfused run of the same query records, so
``profile diff`` lines fused runs up against unfused history.

Selection is structural: a chain is a maximal run of single-child
``TpuExec`` nodes whose ``fusion()`` hook returns a (pure fn, cache
key) pair.  Everything else is a boundary by construction.
"""

from __future__ import annotations

from typing import List, Tuple

from spark_rapids_tpu_torch.exec.base import ExecNode, TpuExec


def _fusable(node: ExecNode):
    """The node's (fn, key) fusion hook, or None when it must stay a
    region boundary."""
    if not isinstance(node, TpuExec) or len(node.children) != 1:
        return None
    from spark_rapids_tpu_torch.exec.fused import FusedStageExec
    if isinstance(node, FusedStageExec):
        return None  # never re-fuse an already-fused region
    return node.fusion()


def fuse_plan(plan: ExecNode, conf) -> Tuple[ExecNode, int]:
    """Rewrite ``plan`` with FusedStageExec regions; returns
    ``(new_plan, regions_built)``.  No-op (0 regions) unless
    ``spark.rapids.tpu.fusion.enabled`` and mode != off."""
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch import fusion as F
    from spark_rapids_tpu_torch.exec.fused import FusedStageExec
    from spark_rapids_tpu_torch.runtime.stats import plan_signature

    if not conf.get(C.FUSION_ENABLED):
        return plan, 0
    mode = str(conf.get(C.FUSION_MODE)).lower()
    if mode == "off":
        return plan, 0
    max_ops = int(conf.get(C.FUSION_MAX_OPS))
    min_len = 1 if mode == "aggressive" else 2
    built = 0

    def walk(node: ExecNode, path: str) -> ExecNode:
        nonlocal built
        members: List[TpuExec] = []
        sigs: List[dict] = []
        cur, cur_path = node, path
        while len(members) < max_ops:
            hook = _fusable(cur)
            if hook is None:
                break
            members.append(cur)
            sigs.append({"op": cur.name,
                         "sig": plan_signature(cur.name, cur_path,
                                               cur.schema),
                         "path": cur_path,
                         "key": hook[1]})
            cur = cur.children[0]
            cur_path += ".0"
        if len(members) < min_len:
            node._children = tuple(
                walk(c, f"{path}.{i}")
                for i, c in enumerate(node.children))
            return node
        source = walk(cur, cur_path)
        # one shared source instance: the region pumps it, and the
        # preserved unfused chain (fall-open) bottoms out on it too
        members[-1]._children = (source,)
        region = FusedStageExec(members, sigs, source)
        built += 1
        F.REGIONS_BUILT.inc()
        return region

    return walk(plan, "0"), built
