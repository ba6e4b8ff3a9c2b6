"""Tree dumps in the reference's format (``isoforest_tpu/utils/inspect.py``).

The reference pins golden tree structures as recursive ``toString`` dumps
(``expectedTreeStructure.txt`` / ``expectedExtendedTreeStructure.txt``,
IsolationForestModelWriteReadTest.scala:391-408), numbers in the JVM's
``Double.toString`` / ``Float.toString`` shortest round-trip rendering.
:func:`tree_structure_string` renders one tree of a port model the same way,
string for string with the JAX package's.
"""

from __future__ import annotations

import numpy as np


def _java_sci(digits: str, exp10: int) -> str:
    """``d.ddd...E±e`` from a shortest-digit string and decimal exponent."""
    mantissa = digits[0] + "." + (digits[1:] or "0")
    return f"{mantissa}E{exp10}"


def _format_java(value: float, shortest: str) -> str:
    """Render like the JVM's Double/Float.toString from a shortest
    round-trip decimal string: plain decimal in [1e-3, 1e7), else
    scientific with ``E``."""
    if value == 0:
        return "-0.0" if np.signbit(value) else "0.0"
    neg = shortest.startswith("-")
    s = shortest.lstrip("-")
    if "e" in s or "E" in s:
        mant, _, exp = s.replace("E", "e").partition("e")
        digits = mant.replace(".", "").lstrip("0") or "0"
        point = mant.find(".")
        int_digits = len(mant[:point] if point >= 0 else mant)
        exp10 = int(exp) + int_digits - 1
    else:
        intpart, _, frac = s.partition(".")
        if intpart.strip("0"):
            digits = (intpart + frac).rstrip("0") or "0"
            exp10 = len(intpart) - 1
        else:
            lead = len(frac) - len(frac.lstrip("0"))
            digits = frac.lstrip("0").rstrip("0") or "0"
            exp10 = -(lead + 1)
    digits = digits.rstrip("0") or "0"
    sign = "-" if neg else ""
    if 1e-3 <= abs(value) < 1e7:
        if exp10 >= 0:
            intp = digits[: exp10 + 1].ljust(exp10 + 1, "0")
            frac = digits[exp10 + 1 :] or "0"
            return f"{sign}{intp}.{frac}"
        return f"{sign}0.{'0' * (-exp10 - 1)}{digits}"
    return sign + _java_sci(digits, exp10)


def java_double_str(value: float) -> str:
    """The JVM's ``Double.toString`` rendering."""
    return _format_java(float(value), repr(float(value)))


def java_float_str(value) -> str:
    """The JVM's ``Float.toString`` rendering (shortest float32 round trip)."""
    v32 = np.float32(value)
    return _format_java(float(v32), np.format_float_positional(v32, unique=True, trim="-"))


def standard_tree_string(feature, threshold, num_instances, slot: int = 0) -> str:
    """Recursive dump of one standard tree from its heap arrays (the
    reference's Nodes.scala ``toString``)."""
    if feature[slot] >= 0:
        left = standard_tree_string(feature, threshold, num_instances, 2 * slot + 1)
        right = standard_tree_string(feature, threshold, num_instances, 2 * slot + 2)
        return (
            f"InternalNode(splitAttribute = {int(feature[slot])}, "
            f"splitValue = {java_double_str(threshold[slot])}, "
            f"leftChild = ({left}), rightChild = ({right}))"
        )
    return f"ExternalNode(numInstances = {int(num_instances[slot])})"


def extended_tree_string(indices, weights, offset, num_instances, slot: int = 0) -> str:
    """Recursive dump of one extended tree from its heap arrays (the
    reference's ExtendedNodes.scala / SplitHyperplane ``toString``)."""
    if indices[slot, 0] >= 0:
        valid = indices[slot] >= 0
        idx_str = ", ".join(str(int(v)) for v in indices[slot][valid])
        w_str = ", ".join(java_float_str(v) for v in weights[slot][valid])
        left = extended_tree_string(indices, weights, offset, num_instances, 2 * slot + 1)
        right = extended_tree_string(indices, weights, offset, num_instances, 2 * slot + 2)
        return (
            f"ExtendedInternalNode(splitHyperplane = SplitHyperplane("
            f"indices = ({idx_str}), weights = ({w_str}), "
            f"offset = {java_double_str(offset[slot])}), "
            f"leftChild = ({left}), rightChild = ({right}))"
        )
    return f"ExtendedExternalNode(numInstances = {int(num_instances[slot])})"


def tree_structure_string(model, tree_id: int = 0) -> str:
    """The reference-format dump of tree ``tree_id`` of a fitted or loaded
    model (its arrays are copied to the host)."""
    from ..ops.ext_growth import ExtendedForest

    forest = model.forest
    if not 0 <= tree_id < forest.num_trees:
        raise IndexError(f"tree_id {tree_id} out of range for a {forest.num_trees}-tree forest")
    tree = [a[tree_id].detach().to("cpu").numpy() for a in forest]
    if isinstance(forest, ExtendedForest):
        return extended_tree_string(*tree)
    return standard_tree_string(*tree)
