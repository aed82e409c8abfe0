"""Parameter trees: the port's nested dicts and lists of tensors (the
counterpart of JAX pytrees) flattened, mapped and listed in one order,
dict insertion order and list order."""
from __future__ import annotations


def tree_flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in the tree's order, paths as the JAX package's
    checkpoints name them (dict keys, ``[i]`` for list items, joined by
    ``/``)."""
    out = {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for key, val in items:
        out.update(tree_flatten(val, f"{prefix}/{key}" if prefix else key))
    return out


def tree_map(fn, tree):
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    return list(tree_flatten(tree).values())
