"""Parameter trees: the port's nested dicts and lists of tensors (the
counterpart of JAX pytrees) flattened, mapped and listed in one order,
dict insertion order and list order.  :func:`tree_flatten`'s
``is_leaf`` marks nodes to keep whole, as JAX's ``is_leaf`` does (a spec
tree's tuples, :func:`repro_torch.launch.mesh.is_spec`)."""
from __future__ import annotations


def tree_flatten(tree, prefix: str = "", is_leaf=None) -> dict:
    """{path: leaf} in the tree's order, paths as the JAX package's
    checkpoints name them (dict keys, ``[i]`` for list items, joined by
    ``/``)."""
    out = {}
    if is_leaf is not None and is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for key, val in items:
        out.update(tree_flatten(val, f"{prefix}/{key}" if prefix else key,
                                is_leaf))
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


def tree_unflatten(tree, leaves):
    """``leaves``, in :func:`tree_leaves` order, in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
