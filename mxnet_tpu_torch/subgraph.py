"""Subgraph partitioning API.

Counterpart of ``mxnet_tpu/subgraph.py``: the ``SubgraphProperty``
registry, the default property, the cycle-safe partitioner and the
MXNET_SUBGRAPH_BACKEND hook, by which a backend claims regions of a
symbolic graph as single fused nodes.  A claimed region becomes one
``_subgraph`` node that runs as one eager callable over the same registry
ops (the JAX package jits each region; the port has no trace).

Grouping is cycle-safe: a node may join a candidate group only if no path
from that group re-enters through a non-member node ("poison" sets).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import MXNetError

__all__ = ["SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_subgraph_backends", "partition"]


class SubgraphProperty:
    """Decides which ops a backend claims (reference: SubgraphProperty).

    Subclass and override op_match (per-node) and optionally
    accept_subgraph (whole-group veto) and min_size.
    """

    name = "base"
    min_size = 2  # singleton groups are not worth a fused node

    def op_match(self, node) -> bool:
        raise NotImplementedError

    def accept_subgraph(self, nodes: Sequence) -> bool:
        return len(nodes) >= self.min_size


# elementwise/compute ops that are always safe to claim: pure, single-output,
# no RNG/aux state (BatchNorm/Dropout stay outside)
_DEFAULT_OPS = {
    "Activation", "relu", "sigmoid", "tanh", "softsign", "exp", "log",
    "sqrt", "square", "negative", "abs", "clip", "LeakyReLU",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
    "FullyConnected", "Convolution", "dot", "Flatten", "reshape",
    "transpose", "Concat", "sum", "mean", "max", "min", "softmax",
    "log_softmax",
}


class DefaultSubgraphProperty(SubgraphProperty):
    """Claims maximal regions of pure compute ops (reference:
    default_subgraph_property.cc)."""

    name = "default"

    def op_match(self, node) -> bool:
        return node.op in _DEFAULT_OPS


_PROPERTIES: Dict[str, SubgraphProperty] = {}


def register_subgraph_property(prop: SubgraphProperty) -> None:
    _PROPERTIES[prop.name] = prop


def get_subgraph_property(name: str) -> SubgraphProperty:
    try:
        return _PROPERTIES[name]
    except KeyError:
        raise MXNetError(
            f"unknown subgraph backend {name!r}; registered: "
            f"{sorted(_PROPERTIES)}") from None


def list_subgraph_backends() -> List[str]:
    return sorted(_PROPERTIES)


register_subgraph_property(DefaultSubgraphProperty())


# ---------------------------------------------------------------------------
# partitioner
# ---------------------------------------------------------------------------
def _group_nodes(order, prop):
    """Assign group ids (or None) to op nodes; cycle-safe.

    poison[n]: set of group ids reachable at n through at least one
    non-member node — n must never join those groups (doing so would put a
    non-member on a path between two members, i.e. a cycle in the
    coarsened graph).  Group ids go through a union-find so that poison
    sets recorded BEFORE a merge still name the merged group correctly.
    """
    group: Dict[int, Optional[int]] = {}
    poison: Dict[int, Set[int]] = {}
    gpoison: Dict[int, Set[int]] = {}
    members: Dict[int, List] = {}
    parent_gid: Dict[int, int] = {}
    next_gid = 0

    def find(g: int) -> int:
        while parent_gid[g] != g:
            parent_gid[g] = parent_gid[parent_gid[g]]
            g = parent_gid[g]
        return g

    def canon(gs: Set[int]) -> Set[int]:
        return {find(g) for g in gs}

    for node in order:
        p: Set[int] = set()
        cand: Set[int] = set()
        for par, _ in node.inputs:
            p |= poison.get(id(par), set())
            pg = group.get(id(par))
            if pg is not None:
                cand.add(find(pg))
        p = canon(p)
        my_group = None
        if not node.is_variable() and prop.op_match(node):
            ok = {g for g in cand if g not in p}
            # merging several groups: each must not be poisoned w.r.t. the
            # others
            safe: List[int] = []
            for g in sorted(ok):
                if all(g not in canon(gpoison.get(o, set()))
                       and o not in canon(gpoison.get(g, set()))
                       for o in safe):
                    safe.append(g)
            if safe:
                my_group = safe[0]
                for g in safe[1:]:
                    parent_gid[g] = my_group
                    members[my_group].extend(members.pop(g))
                    gpoison[my_group] |= gpoison.pop(g, set())
                members[my_group].append(node)
            else:
                my_group = next_gid
                next_gid += 1
                parent_gid[my_group] = my_group
                members[my_group] = [node]
                gpoison[my_group] = set()
            group[id(node)] = my_group
            gpoison[my_group] |= p
        else:
            group[id(node)] = None
        # groups whose values flow PAST this node while it is not a member
        # (compare through find(): ids in cand may have just been merged
        # into my_group — poisoning those would wall off our own group)
        mg = find(my_group) if my_group is not None else None
        poison[id(node)] = p | {g for g in cand if find(g) != mg}

    # resolve every node's group to its canonical id
    group = {k: (find(v) if v is not None else None)
             for k, v in group.items()}
    return group, members


def partition(sym, backend_or_prop="default"):
    """Partition a Symbol's graph for a backend; claimed regions become
    single '_subgraph' nodes running the region as one callable.
    """
    from .symbol.symbol import Symbol, _Node, _topo_order, _apply_node

    prop = (backend_or_prop if isinstance(backend_or_prop, SubgraphProperty)
            else get_subgraph_property(backend_or_prop))
    entries = sym._entries
    order = _topo_order(entries)
    group, members = _group_nodes(order, prop)

    # veto small groups
    for gid in list(members):
        if not prop.accept_subgraph(members[gid]):
            for m in members[gid]:
                group[id(m)] = None
            del members[gid]

    if not members:
        return sym

    member_ids = {id(m): gid for gid, ms in members.items() for m in ms}
    # external inputs (entries from non-members) and outputs (member entries
    # consumed outside, or graph outputs) per group, in deterministic order
    ext_inputs: Dict[int, List[Tuple]] = {g: [] for g in members}
    outputs: Dict[int, List[Tuple]] = {g: [] for g in members}

    def note_input(gid, entry):
        if all(e[0] is not entry[0] or e[1] != entry[1]
               for e in ext_inputs[gid]):
            ext_inputs[gid].append(entry)

    def note_output(gid, entry):
        if all(e[0] is not entry[0] or e[1] != entry[1]
               for e in outputs[gid]):
            outputs[gid].append(entry)

    for node in order:
        gid = member_ids.get(id(node))
        for parent, oi in node.inputs:
            pgid = member_ids.get(id(parent))
            if gid is not None and pgid != gid:
                note_input(gid, (parent, oi))
            if pgid is not None and gid != pgid:
                note_output(pgid, (parent, oi))
    for e in entries:
        pgid = member_ids.get(id(e[0]))
        if pgid is not None:
            note_output(pgid, e)

    def make_subgraph_fn(gid):
        ins = ext_inputs[gid]
        outs = outputs[gid]
        mset = {id(m) for m in members[gid]}
        # close over only this group's nodes (topo order), not the whole
        # pre-partition graph
        member_order = [n for n in order if id(n) in mset]

        def fn(*ext_vals):
            vals: Dict[int, dict] = {}
            for (n, oi), v in zip(ins, ext_vals):
                vals.setdefault(id(n), {})[oi] = v
            for node in member_order:
                node_in = [vals[id(p)][oi] for p, oi in node.inputs]
                out = _apply_node(node, node_in, False)
                out = list(out) if isinstance(out, (tuple, list)) else [out]
                vals[id(node)] = dict(enumerate(out))
            return tuple(vals[id(n)][oi] for n, oi in outs)

        return fn

    # rebuild the graph with each group collapsed into one _subgraph node
    memo: Dict[int, _Node] = {}
    gnode: Dict[int, _Node] = {}

    def rebuild_entry(entry):
        node, oi = entry
        gid = member_ids.get(id(node))
        if gid is not None:
            sg = build_group(gid)
            pos = next(i for i, (n, o) in enumerate(outputs[gid])
                       if n is node and o == oi)
            return (sg, pos)
        return (rebuild(node), oi)

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.is_variable():
            memo[id(node)] = node
            return node
        new_inputs = [rebuild_entry(e) for e in node.inputs]
        nn = _Node(node.op, node.name, node.attrs, new_inputs,
                   node.num_outputs, getattr(node, "vattrs", None))
        memo[id(node)] = nn
        return nn

    _building: Set[int] = set()

    def build_group(gid):
        if gid in gnode:
            return gnode[gid]
        if gid in _building:  # defensive: a cycle here is a partitioner bug
            raise MXNetError(
                f"subgraph partition produced a cyclic coarsened graph "
                f"(group {gid}) — please report")
        _building.add(gid)
        new_inputs = [rebuild_entry(e) for e in ext_inputs[gid]]
        nn = _Node("_subgraph", f"{prop.name}_subgraph{gid}",
                   {"fn": make_subgraph_fn(gid),
                    "backend": prop.name,
                    "num_nodes": len(members[gid]),
                    "ops": sorted({m.op for m in members[gid]})},
                   new_inputs, num_outputs=len(outputs[gid]))
        gnode[gid] = nn
        return nn

    return Symbol([rebuild_entry(e) for e in entries])


def env_backend() -> Optional[str]:
    """MXNET_SUBGRAPH_BACKEND env hook (reference: build_subgraph.cc)."""
    name = os.environ.get("MXNET_SUBGRAPH_BACKEND", "").strip()
    return name or None
