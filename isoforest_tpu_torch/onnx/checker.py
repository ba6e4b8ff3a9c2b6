"""Independent structural validation of emitted ONNX model bytes.

The reference gates its converter with ``onnx.checker.check_model``
(``isolation-forest-onnx/src/isolationforestonnx/isolation_forest_converter.py:168-173``)
and an onnxruntime score-parity integration test. The port depends on
neither package, and a parity gate of the converter against the bundled
evaluator alone is author-correlated, since both share ``proto.py``'s field
tables. This module breaks the correlation:

* its own protobuf **wire reader** with field numbers transcribed afresh from
  the public ``onnx/onnx.proto`` and ``onnx/onnx-ml.proto`` descriptors —
  it deliberately imports nothing from :mod:`.proto`, so a field-number slip
  in the writer surfaces as a parse/validation failure here instead of
  cancelling out;
* :func:`check_model` — the structural constraints ``onnx.checker`` enforces
  for the emitted subgraph (ir/opset validity, graph SSA + topological
  ordering, per-op schema checks including the full ``TreeEnsembleRegressor``
  attribute consistency rules of the ``ai.onnx.ml`` spec);
* :func:`reference_scores` — an independent scalar evaluator (per-row
  recursive tree walk straight from the ``ai.onnx.ml`` operator spec, plain
  numpy for the core ops) so score parity is checked by a third
  implementation that shares no code with :mod:`.runtime`.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np


class CheckError(ValueError):
    """A structural violation ``onnx.checker`` would reject."""


# --------------------------------------------------------------------------- #
# wire reader (transcribed from onnx.proto; shares nothing with .proto)
# --------------------------------------------------------------------------- #


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) triples from a message body."""
    pos, n = 0, len(data)
    while pos < n:
        tag = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, val
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, data[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, data[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, wire, data[pos : pos + 8]
            pos += 8
        else:
            raise CheckError(f"unsupported protobuf wire type {wire}")


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(data: bytes) -> List[int]:
    """Vectorised packed-varint decode (profile hotspot at 500k-element
    TreeEnsembleRegressor attribute arrays). Strictly 64-bit: payload bits
    beyond 64 wrap, and varints longer than the protobuf maximum of 10
    bytes raise :class:`CheckError` (a checker SHOULD reject them; the
    earlier scalar loop permissively decoded unbounded varints)."""
    b = np.frombuffer(data, np.uint8)
    if b.size == 0:
        return []
    term = (b & 0x80) == 0
    if not term[-1]:
        raise CheckError("truncated varint in packed field")
    gid = np.zeros(b.size, np.int64)
    gid[1:] = np.cumsum(term.astype(np.int64))[:-1]
    starts = np.zeros(int(term.sum()), np.int64)
    starts[1:] = np.nonzero(term)[0][:-1] + 1
    pos = np.arange(b.size, dtype=np.int64) - starts[gid]
    if int(pos.max()) > 9:
        raise CheckError("varint longer than 10 bytes in packed field")
    vals = np.zeros(starts.size, np.uint64)
    np.bitwise_or.at(
        vals, gid, (b & np.uint8(0x7F)).astype(np.uint64) << (7 * pos).astype(np.uint64)
    )
    return vals.view(np.int64).tolist()  # two's-complement reinterpret


# AttributeProto (onnx.proto): name=1 f=2 i=3 s=4 t=5 floats=7 ints=8
# strings=9 type=20
def _parse_attribute(data: bytes) -> Tuple[str, Any, int]:
    name, atype = "", 0
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _fields(data):
        if field == 1:
            name = val.decode()
        elif field == 2:
            f_val = struct.unpack("<f", val)[0]
        elif field == 3:
            i_val = _signed(val)
        elif field == 4:
            s_val = val
        elif field == 5:
            t_val = val
        elif field == 7:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            if wire == 2:
                ints.extend(_packed_varints(val))
            else:
                ints.append(_signed(val))
        elif field == 9:
            strings.append(val)
        elif field == 20:
            atype = val
    by_type = {
        1: f_val,
        2: i_val,
        3: s_val.decode() if s_val is not None else None,
        4: t_val,
        6: floats,
        7: ints,
        8: [s.decode() for s in strings],
    }
    if atype not in by_type:
        raise CheckError(f"attribute {name!r}: unsupported AttributeType {atype}")
    return name, by_type[atype], atype


# TensorProto: dims=1 data_type=2 float_data=4 int32_data=5 int64_data=7
# name=8 raw_data=9
_TENSOR_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 11: np.float64}
_VALID_ELEM_TYPES = set(range(1, 17))


def _parse_tensor(data: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = None
    raw = None
    floats: List[float] = []
    ints: List[int] = []
    name = ""
    for field, wire, val in _fields(data):
        if field == 1:  # dims: packed (proto3) or unpacked varints
            if wire == 2:
                dims.extend(_packed_varints(val))
            else:
                dims.append(_signed(val))
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field in (5, 7):  # int32_data / int64_data, packed or not
            if wire == 2:
                ints.extend(_packed_varints(val))
            else:
                ints.append(_signed(val))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    if dtype not in _TENSOR_DTYPES:
        raise CheckError(f"initializer {name!r}: unsupported data_type {dtype}")
    np_dtype = _TENSOR_DTYPES[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    else:
        arr = np.asarray(ints, np_dtype)
    want = int(np.prod(dims)) if dims else arr.size
    if arr.size != want:
        raise CheckError(
            f"initializer {name!r}: dims {dims} need {want} elements, "
            f"payload has {arr.size}"
        )
    return name, arr.reshape(dims) if dims else arr


# ValueInfoProto: name=1 type=2 | TypeProto.tensor_type=1 |
# TypeProto.Tensor: elem_type=1 shape=2
def _parse_value_info(data: bytes) -> Tuple[str, int]:
    name, elem = "", -1
    for field, _, val in _fields(data):
        if field == 1:
            name = val.decode()
        elif field == 2:
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
    return name, elem


# NodeProto: input=1 output=2 name=3 op_type=4 attribute=5 domain=7
def _parse_node(data: bytes) -> dict:
    node = {"input": [], "output": [], "name": "", "op_type": "", "domain": "", "attrs": {}}
    for field, _, val in _fields(data):
        if field == 1:
            node["input"].append(val.decode())
        elif field == 2:
            node["output"].append(val.decode())
        elif field == 3:
            node["name"] = val.decode()
        elif field == 4:
            node["op_type"] = val.decode()
        elif field == 5:
            aname, aval, _ = _parse_attribute(val)
            node["attrs"][aname] = aval
        elif field == 7:
            node["domain"] = val.decode()
    return node


def parse_model_independent(model_bytes: bytes) -> dict:
    """ModelProto: ir_version=1 graph=7 opset_import=8;
    GraphProto: node=1 name=2 initializer=5 input=11 output=12;
    OperatorSetIdProto: domain=1 version=2.

    Truncated/corrupt bytes raise :class:`CheckError` (the wire readers hit
    IndexError/struct.error; callers rely on one structured exception)."""
    try:
        return _parse_model_inner(model_bytes)
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise CheckError(f"truncated or corrupt model bytes: {e}") from e


def _parse_model_inner(model_bytes: bytes) -> dict:
    model = {"ir_version": None, "opsets": {}, "graph": None}
    for field, _, val in _fields(model_bytes):
        if field == 1:
            model["ir_version"] = _signed(val)
        elif field == 7:
            graph = {
                "nodes": [],
                "name": "",
                "initializers": {},
                "inputs": [],
                "outputs": [],
            }
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    graph["nodes"].append(_parse_node(v2))
                elif f2 == 2:
                    graph["name"] = v2.decode()
                elif f2 == 5:
                    tname, arr = _parse_tensor(v2)
                    graph["initializers"][tname] = arr
                elif f2 == 11:
                    graph["inputs"].append(_parse_value_info(v2))
                elif f2 == 12:
                    graph["outputs"].append(_parse_value_info(v2))
            model["graph"] = graph
        elif field == 8:
            domain, version = "", None
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    domain = v2.decode()
                elif f2 == 2:
                    version = _signed(v2)
            model["opsets"][domain] = version
    return model


# --------------------------------------------------------------------------- #
# structural checks (mirroring onnx.checker.check_model for this subgraph)
# --------------------------------------------------------------------------- #

_BRANCH_MODES = {
    "BRANCH_LEQ",
    "BRANCH_LT",
    "BRANCH_GTE",
    "BRANCH_GT",
    "BRANCH_EQ",
    "BRANCH_NEQ",
    "LEAF",
}
_AGG_FUNCS = {"AVERAGE", "SUM", "MIN", "MAX"}
_POST_TRANSFORMS = {"NONE", "SOFTMAX", "LOGISTIC", "SOFTMAX_ZERO", "PROBIT"}

# op_type -> (domain, n_inputs, n_outputs, required attrs)
_CORE_OPS = {
    "MatMul": ("", 2, 1, ()),
    "Div": ("", 2, 1, ()),
    "Neg": ("", 1, 1, ()),
    "Pow": ("", 2, 1, ()),
    "Less": ("", 2, 1, ()),
    "Not": ("", 1, 1, ()),
    "Cast": ("", 1, 1, ("to",)),
    "Constant": ("", 0, 1, ()),
    "TreeEnsembleRegressor": ("ai.onnx.ml", 1, 1, ("n_targets",)),
}


def _check_tree_ensemble(attrs: dict) -> None:
    """Vectorised: the pure-Python loop form cost seconds at 1000-tree
    (~500k-node) scale, the very scale the native save path exists for."""
    node_arrays = [
        "nodes_treeids",
        "nodes_nodeids",
        "nodes_featureids",
        "nodes_values",
        "nodes_modes",
        "nodes_truenodeids",
        "nodes_falsenodeids",
    ]
    lengths = set()
    for key in node_arrays:
        if key not in attrs:
            raise CheckError(f"TreeEnsembleRegressor missing attribute {key!r}")
        lengths.add(len(attrs[key]))
    if len(lengths) != 1:
        raise CheckError(
            f"TreeEnsembleRegressor nodes_* arrays disagree in length: {lengths}"
        )
    modes = np.asarray(attrs["nodes_modes"])
    bad_modes = set(np.unique(modes)) - _BRANCH_MODES
    if bad_modes:
        raise CheckError(f"invalid nodes_modes values {bad_modes}")
    tids = np.asarray(attrs["nodes_treeids"], np.int64)
    nids = np.asarray(attrs["nodes_nodeids"], np.int64)
    true_ids = np.asarray(attrs["nodes_truenodeids"], np.int64)
    false_ids = np.asarray(attrs["nodes_falsenodeids"], np.int64)
    fids = np.asarray(attrs["nodes_featureids"], np.int64)
    if fids.size and fids.min() < 0:
        raise CheckError(f"negative nodes_featureids entry {fids.min()}")
    # pack (treeid, nodeid) into one sortable key for set-free membership
    base = max(int(nids.max(initial=0)), int(true_ids.max(initial=0)),
               int(false_ids.max(initial=0))) + 2
    keys = tids * base + nids
    sorted_keys = np.sort(keys)
    if sorted_keys.size > 1 and (np.diff(sorted_keys) == 0).any():
        raise CheckError("duplicate (treeid, nodeid) pairs in node table")

    def _member(t, n):
        pos = np.searchsorted(sorted_keys, t * base + n)
        pos = np.clip(pos, 0, sorted_keys.size - 1)
        return sorted_keys[pos] == t * base + n

    internal = modes != "LEAF"
    ok_true = _member(tids[internal], true_ids[internal])
    ok_false = _member(tids[internal], false_ids[internal])
    if not (ok_true.all() and ok_false.all()):
        bad = np.nonzero(~(ok_true & ok_false))[0][0]
        t_bad = tids[internal][bad]
        n_bad = nids[internal][bad]
        raise CheckError(
            f"node ({t_bad},{n_bad}) branches to nonexistent child "
            f"({true_ids[internal][bad]}/{false_ids[internal][bad]})"
        )
    target_arrays = ["target_treeids", "target_nodeids", "target_ids", "target_weights"]
    t_lengths = set()
    for key in target_arrays:
        if key not in attrs:
            raise CheckError(f"TreeEnsembleRegressor missing attribute {key!r}")
        t_lengths.add(len(attrs[key]))
    if len(t_lengths) != 1:
        raise CheckError(
            f"TreeEnsembleRegressor target_* arrays disagree in length: {t_lengths}"
        )
    n_targets = attrs["n_targets"]
    t_ids = np.asarray(attrs["target_ids"], np.int64)
    if t_ids.size and (t_ids.min() < 0 or t_ids.max() >= n_targets):
        raise CheckError(f"target_ids entries outside [0, {n_targets})")
    tt = np.asarray(attrs["target_treeids"], np.int64)
    tn = np.asarray(attrs["target_nodeids"], np.int64)
    ok_t = _member(tt, tn)
    if not ok_t.all():
        bad = np.nonzero(~ok_t)[0][0]
        raise CheckError(f"target references nonexistent node ({tt[bad]},{tn[bad]})")
    agg = attrs.get("aggregate_function", "SUM")
    if agg not in _AGG_FUNCS:
        raise CheckError(f"invalid aggregate_function {agg!r}")
    post = attrs.get("post_transform", "NONE")
    if post not in _POST_TRANSFORMS:
        raise CheckError(f"invalid post_transform {post!r}")
    _check_acyclic_reachable(tids, nids, internal, true_ids, false_ids, base,
                             keys, sorted_keys)


def _check_acyclic_reachable(tids, nids, internal, true_ids, false_ids, base,
                             keys, sorted_keys) -> None:
    """Acyclicity + reachability: every tree must be a rooted binary tree,
    not merely have in-range child ids — a back-edge would make any
    evaluator's walk diverge (the model loader already rejects cyclic node
    tables; the export gate must be at least as strict). Vectorised BFS over
    ALL trees simultaneously: each wave resolves child positions with one
    searchsorted; bounded by the node count."""
    n = keys.size
    order = np.argsort(keys)
    # per-node child POSITIONS (into the node arrays), -1 for leaves
    def _pos(t, child):
        p = np.searchsorted(sorted_keys, t * base + child)
        p = np.clip(p, 0, n - 1)
        return order[p]  # membership already validated

    true_pos = np.full(n, -1, np.int64)
    false_pos = np.full(n, -1, np.int64)
    idx_internal = np.nonzero(internal)[0]
    true_pos[idx_internal] = _pos(tids[idx_internal], true_ids[idx_internal])
    false_pos[idx_internal] = _pos(tids[idx_internal], false_ids[idx_internal])

    roots_mask = nids == 0
    tree_ids = np.unique(tids)
    if roots_mask.sum() != tree_ids.size:
        missing = set(tree_ids) - set(tids[roots_mask])
        raise CheckError(f"tree(s) {sorted(missing)[:5]} have no root node 0")
    visits = np.zeros(n, np.int64)
    frontier = np.nonzero(roots_mask)[0]
    waves = 0
    while frontier.size:
        waves += 1
        if waves > n + 1:
            raise CheckError("cyclic node table (BFS exceeded node count)")
        np.add.at(visits, frontier, 1)
        fresh = frontier[visits[frontier] == 1]  # expand first visits only
        kids = np.concatenate([true_pos[fresh], false_pos[fresh]])
        frontier = kids[kids >= 0]
    if (visits > 1).any():
        bad = np.nonzero(visits > 1)[0][0]
        raise CheckError(
            f"tree {tids[bad]}: node {nids[bad]} reached twice — cyclic or "
            "converging node table"
        )
    if (visits == 0).any():
        bad = np.nonzero(visits == 0)[0]
        raise CheckError(
            f"{bad.size} node(s) unreachable from their roots "
            f"(first: tree {tids[bad[0]]} node {nids[bad[0]]})"
        )


def check_model(model_bytes: bytes) -> dict:
    """Validate emitted bytes; returns the independently-parsed model.

    Mirrors the constraints ``onnx.checker.check_model`` applies to this
    graph family: version/opset sanity, non-empty SSA graph in topological
    order, per-op schema conformance (arity, required attributes, domain
    registration), initializer well-formedness, and the ``ai.onnx.ml``
    TreeEnsembleRegressor consistency rules.
    """
    model = parse_model_independent(model_bytes)
    ir = model["ir_version"]
    if ir is None or not 3 <= ir <= 12:
        raise CheckError(f"ir_version {ir} outside supported range [3, 12]")
    if not model["opsets"]:
        raise CheckError("model has no opset_import")
    for domain, version in model["opsets"].items():
        if version is None or version < 1:
            raise CheckError(f"opset for domain {domain!r} has no valid version")
    graph = model["graph"]
    if graph is None or not graph["nodes"]:
        raise CheckError("model has no graph / graph has no nodes")
    if not graph["name"]:
        raise CheckError("graph name is empty")
    if not graph["inputs"] or not graph["outputs"]:
        raise CheckError("graph must declare inputs and outputs")
    for vname, elem in graph["inputs"] + graph["outputs"]:
        if not vname:
            raise CheckError("graph input/output with empty name")
        if elem not in _VALID_ELEM_TYPES:
            raise CheckError(f"value {vname!r} has invalid elem_type {elem}")
    known = {name for name, _ in graph["inputs"]}
    known.update(graph["initializers"])
    produced: set = set()
    for node in graph["nodes"]:
        op = node["op_type"]
        if op not in _CORE_OPS:
            raise CheckError(f"unexpected op {op!r} in isolation-forest graph")
        domain, n_in, n_out, required = _CORE_OPS[op]
        if node["domain"] != domain:
            raise CheckError(f"{op}: domain {node['domain']!r} != {domain!r}")
        if domain not in model["opsets"]:
            raise CheckError(f"{op}: domain {domain!r} not in opset_import")
        if len(node["input"]) != n_in or len(node["output"]) != n_out:
            raise CheckError(
                f"{op}: arity {len(node['input'])}->{len(node['output'])}, "
                f"expected {n_in}->{n_out}"
            )
        for attr in required:
            if attr not in node["attrs"]:
                raise CheckError(f"{op}: missing required attribute {attr!r}")
        for inp in node["input"]:
            if inp not in known:
                raise CheckError(
                    f"{op}: input {inp!r} not defined before use (not SSA/topo)"
                )
        for outp in node["output"]:
            if outp in produced:
                raise CheckError(f"duplicate output name {outp!r} (not SSA)")
            produced.add(outp)
            known.add(outp)
        if op == "TreeEnsembleRegressor":
            _check_tree_ensemble(node["attrs"])
        if op == "Cast" and node["attrs"]["to"] not in _VALID_ELEM_TYPES:
            raise CheckError(f"Cast: invalid 'to' dtype {node['attrs']['to']}")
    for vname, _ in graph["outputs"]:
        if vname not in produced and vname not in known:
            raise CheckError(f"graph output {vname!r} is never produced")
    return model


# --------------------------------------------------------------------------- #
# independent evaluator
# --------------------------------------------------------------------------- #


def _eval_tree_walk(attrs: dict, X: np.ndarray) -> np.ndarray:
    """Scalar per-row walk straight from the ai.onnx.ml spec — no vectorised
    shortcuts shared with :mod:`.runtime`'s evaluator."""
    nodes: Dict[Tuple[int, int], dict] = {}
    for i, (tid, nid) in enumerate(zip(attrs["nodes_treeids"], attrs["nodes_nodeids"])):
        nodes[(tid, nid)] = {
            "mode": attrs["nodes_modes"][i],
            "feature": attrs["nodes_featureids"][i],
            "value": attrs["nodes_values"][i],
            "true": attrs["nodes_truenodeids"][i],
            "false": attrs["nodes_falsenodeids"][i],
        }
    leaf_weight: Dict[Tuple[int, int], float] = {}
    for tid, nid, weight in zip(
        attrs["target_treeids"], attrs["target_nodeids"], attrs["target_weights"]
    ):
        leaf_weight[(tid, nid)] = leaf_weight.get((tid, nid), 0.0) + weight
    tree_ids = sorted(set(attrs["nodes_treeids"]))
    agg = attrs.get("aggregate_function", "SUM")
    out = np.zeros((X.shape[0], 1), np.float32)
    max_steps = len(nodes) + 1  # acyclicity is checked, but stay bounded
    for r in range(X.shape[0]):
        row = X[r]
        total = 0.0
        for tid in tree_ids:
            nid = 0
            for _ in range(max_steps):
                node = nodes[(tid, nid)]
                if node["mode"] == "LEAF":
                    total += leaf_weight.get((tid, nid), 0.0)
                    break
                x = float(row[node["feature"]])
                v = node["value"]
                mode = node["mode"]
                if mode == "BRANCH_LT":
                    take_true = x < v
                elif mode == "BRANCH_LEQ":
                    take_true = x <= v
                elif mode == "BRANCH_GT":
                    take_true = x > v
                elif mode == "BRANCH_GTE":
                    take_true = x >= v
                elif mode == "BRANCH_EQ":
                    take_true = x == v
                else:
                    take_true = x != v
                nid = node["true"] if take_true else node["false"]
            else:
                raise CheckError(f"tree {tid}: walk exceeded node count")
        if agg == "AVERAGE":
            total /= len(tree_ids)
        out[r, 0] = total
    return out


def reference_scores(model_bytes: bytes, X: np.ndarray) -> np.ndarray:
    """Evaluate the full graph independently; returns the score column."""
    model = check_model(model_bytes)
    graph = model["graph"]
    env: Dict[str, np.ndarray] = dict(graph["initializers"])
    env[graph["inputs"][0][0]] = np.asarray(X, np.float32)
    for node in graph["nodes"]:
        op = node["op_type"]
        ins = [env[i] for i in node["input"]]
        if op == "Constant":
            _, arr = _parse_tensor(node["attrs"]["value"])
            res = arr
        elif op == "MatMul":
            res = np.matmul(ins[0], ins[1])
        elif op == "TreeEnsembleRegressor":
            res = _eval_tree_walk(node["attrs"], np.asarray(ins[0], np.float32))
        elif op == "Div":
            res = ins[0] / ins[1]
        elif op == "Neg":
            res = -ins[0]
        elif op == "Pow":
            res = np.power(ins[0], ins[1])
        elif op == "Less":
            res = ins[0] < ins[1]
        elif op == "Not":
            res = ~ins[0]
        elif op == "Cast":
            res = ins[0].astype(_TENSOR_DTYPES[node["attrs"]["to"]])
        else:  # unreachable: check_model restricts the op set
            raise CheckError(f"cannot evaluate op {op!r}")
        env[node["output"][0]] = res
    score_name = graph["outputs"][0][0]
    return np.asarray(env[score_name], np.float32)
