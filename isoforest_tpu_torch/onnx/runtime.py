"""Tiny numpy evaluator for the converter's ONNX graphs.

The port does not depend on onnxruntime, so this module provides (a) the test
oracle proving the exported graph computes the same scores/labels as the
port's scorer — the analogue of the reference's two-phase Spark->ONNX parity
integration test (max |spark - onnx| < 1e-5) — and (b) a dependency-free
portable-inference fallback. Implements exactly the ops the converter emits:
``ai.onnx.ml.TreeEnsembleRegressor`` (AVERAGE / BRANCH_LT / LEAF),
Div, Neg, Pow, Less, Not, Cast.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from . import proto


def _parse_attr(data: bytes):
    fields = proto.decode_message(data)
    name = fields[1][0][1].decode()
    atype = fields.get(20, [(0, 0)])[0][1]
    if atype == proto.ATTR_FLOAT:
        return name, struct.unpack("<f", fields[2][0][1])[0]
    if atype == proto.ATTR_INT:
        return name, fields[3][0][1]
    if atype == proto.ATTR_STRING:
        return name, fields[4][0][1].decode()
    if atype == proto.ATTR_TENSOR:
        return name, _parse_tensor(fields[5][0][1])
    if atype == proto.ATTR_FLOATS:
        vals = []
        for wire, payload in fields.get(7, []):
            vals += proto.unpack_floats(payload) if wire == 2 else [
                struct.unpack("<f", payload)[0]
            ]
        return name, np.asarray(vals, np.float32)
    if atype == proto.ATTR_INTS:
        vals = []
        for wire, payload in fields.get(8, []):
            vals += proto.unpack_varints(payload) if wire == 2 else [payload]
        return name, np.asarray(vals, np.int64)
    if atype == proto.ATTR_STRINGS:
        return name, [payload.decode() for _, payload in fields.get(9, [])]
    raise ValueError(f"unsupported attribute type {atype}")


def _parse_tensor(data: bytes) -> np.ndarray:
    fields = proto.decode_message(data)
    dims = []
    for wire, payload in fields.get(1, []):
        dims += proto.unpack_varints(payload) if wire == 2 else [payload]
    dtype = fields.get(2, [(0, proto.FLOAT)])[0][1]
    raw = fields.get(9, [(2, b"")])[0][1]
    np_dtype = {
        proto.FLOAT: np.float32,
        proto.INT32: np.int32,
        proto.INT64: np.int64,
        proto.DOUBLE: np.float64,
        proto.BOOL: np.bool_,
    }[dtype]
    arr = np.frombuffer(raw, np_dtype)
    return arr.reshape(dims) if dims else arr


def _parse_node(data: bytes) -> dict:
    fields = proto.decode_message(data)
    return {
        "inputs": [v.decode() for _, v in fields.get(1, [])],
        "outputs": [v.decode() for _, v in fields.get(2, [])],
        "op_type": fields[4][0][1].decode(),
        "domain": fields.get(7, [(2, b"")])[0][1].decode(),
        "attrs": dict(_parse_attr(v) for _, v in fields.get(5, [])),
    }


def parse_model(model_bytes: bytes) -> dict:
    """ModelProto bytes -> {nodes, initializers, inputs, outputs, opsets}."""
    m = proto.decode_message(model_bytes)
    g = proto.decode_message(m[7][0][1])
    nodes = [_parse_node(v) for _, v in g.get(1, [])]
    initializers = {}
    for _, v in g.get(5, []):
        t = _parse_tensor(v)
        name = proto.decode_message(v)[8][0][1].decode()
        initializers[name] = t
    inputs = [
        proto.decode_message(v)[1][0][1].decode() for _, v in g.get(11, [])
    ]
    outputs = [
        proto.decode_message(v)[1][0][1].decode() for _, v in g.get(12, [])
    ]
    opsets = []
    for _, v in m.get(8, []):
        f = proto.decode_message(v)
        domain = f.get(1, [(2, b"")])[0][1].decode()
        opsets.append((domain, f[2][0][1]))
    return {
        "ir_version": m[1][0][1],
        "nodes": nodes,
        "initializers": initializers,
        "inputs": inputs,
        "outputs": outputs,
        "opsets": opsets,
    }


def _eval_tree_ensemble(attrs: dict, X: np.ndarray) -> np.ndarray:
    treeids = np.asarray(attrs["nodes_treeids"], np.int64)
    nodeids = np.asarray(attrs["nodes_nodeids"], np.int64)
    featureids = np.asarray(attrs["nodes_featureids"], np.int64)
    values = np.asarray(attrs["nodes_values"], np.float32)
    true_ids = np.asarray(attrs["nodes_truenodeids"], np.int64)
    false_ids = np.asarray(attrs["nodes_falsenodeids"], np.int64)
    modes = attrs["nodes_modes"]
    if any(m not in ("BRANCH_LT", "LEAF") for m in modes):
        raise ValueError("evaluator supports BRANCH_LT/LEAF modes only")
    is_leaf = np.asarray([m == "LEAF" for m in modes])

    num_trees = int(treeids.max()) + 1
    max_nodes = int(nodeids.max()) + 1
    feat = np.zeros((num_trees, max_nodes), np.int64)
    val = np.zeros((num_trees, max_nodes), np.float32)
    tid = np.zeros((num_trees, max_nodes), np.int64)
    fid = np.zeros((num_trees, max_nodes), np.int64)
    leaf = np.ones((num_trees, max_nodes), np.bool_)
    feat[treeids, nodeids] = featureids
    val[treeids, nodeids] = values
    tid[treeids, nodeids] = true_ids
    fid[treeids, nodeids] = false_ids
    leaf[treeids, nodeids] = is_leaf

    weights = np.zeros((num_trees, max_nodes), np.float32)
    weights[
        np.asarray(attrs["target_treeids"], np.int64),
        np.asarray(attrs["target_nodeids"], np.int64),
    ] = np.asarray(attrs["target_weights"], np.float32)

    n = X.shape[0]
    total = np.zeros(n, np.float32)
    for t in range(num_trees):
        node = np.zeros(n, np.int64)
        active = ~leaf[t, node]
        while active.any():
            f = feat[t, node]
            cond = X[np.arange(n), f] < val[t, node]  # BRANCH_LT: true -> left
            nxt = np.where(cond, tid[t, node], fid[t, node])
            node = np.where(active, nxt, node)
            active = active & ~leaf[t, node]
        total += weights[t, node]
    if attrs.get("aggregate_function", "AVERAGE") == "AVERAGE":
        total /= num_trees
    return total[:, None].astype(np.float32)


def run_model(model_bytes: bytes, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """Execute the graph; returns outputs in graph-output order."""
    parsed = parse_model(model_bytes)
    env: Dict[str, np.ndarray] = dict(parsed["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    for nd in parsed["nodes"]:
        op = nd["op_type"]
        ins = [env[i] for i in nd["inputs"]]
        if op == "MatMul":
            out = (np.asarray(ins[0], np.float32) @ np.asarray(ins[1], np.float32)).astype(
                np.float32
            )
        elif op == "TreeEnsembleRegressor":
            out = _eval_tree_ensemble(nd["attrs"], np.asarray(ins[0], np.float32))
        elif op == "Div":
            out = (ins[0] / ins[1]).astype(np.float32)
        elif op == "Neg":
            out = -ins[0]
        elif op == "Pow":
            out = np.power(ins[0], ins[1]).astype(np.float32)
        elif op == "Less":
            out = ins[0] < ins[1]
        elif op == "Not":
            out = ~ins[0]
        elif op == "Cast":
            np_dtype = {
                proto.INT32: np.int32,
                proto.INT64: np.int64,
                proto.FLOAT: np.float32,
                proto.DOUBLE: np.float64,
                proto.BOOL: np.bool_,
            }[nd["attrs"]["to"]]
            out = ins[0].astype(np_dtype)
        else:
            raise ValueError(f"unsupported op {op}")
        env[nd["outputs"][0]] = out
    return [env[name] for name in parsed["outputs"]]
