"""Carry a JAX parameter tree into the port's ``Model``, and the port's axes.

The JAX package's ``Model.init`` gives a nested dict whose ``units`` and
``encoder`` leaves carry a leading G axis (one slice a unit); the port holds
those units in an ``nn.ModuleList``. ``load_jax_params`` takes that tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and fills the port's
module, unit g from slice g; ``param_axes`` gives the port's ``Axes`` tree in
the JAX tree's shape. ``load_jax_opt_state`` does the same for the JAX
optimizer state, and ``jax_layout`` / ``from_jax_layout`` carry any port tree
(``units``/``encoder`` as lists of per-unit trees) to the JAX tree's flat
leaves and back: the checkpoint format. None of them imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .transformer import STACKED, Model, shapes_and_axes


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _targets(model: Model) -> dict:
    """JAX leaf path -> (the JAX leaf's shape, the port's tensors it fills:
    one, or one a unit for a stacked path)."""
    out = {}
    for k, v in model.tree().items():
        if k in STACKED:
            per_unit = [_flat(u) for u in v]
            for path, t in per_unit[0].items():
                out[(k,) + path] = ((len(v),) + tuple(t.shape), [u[path] for u in per_unit])
        elif isinstance(v, dict):
            out.update({(k,) + p: (tuple(t.shape), [t]) for p, t in _flat(v).items()})
        else:
            out[(k,)] = (tuple(v.shape), [v])
    return out


@torch.no_grad()
def load_jax_params(model: Model, params: dict) -> Model:
    """Fill ``model`` from the JAX package's parameter tree (nested dict of
    numpy arrays). Raises ValueError on a missing, extra or mis-shaped leaf,
    before anything is written."""
    want, got = _targets(model), _flat(params)
    missing = sorted(".".join(p) for p in want.keys() - got.keys())
    extra = sorted(".".join(p) for p in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"JAX params do not fit {model.cfg.name}: missing {missing}, "
                         f"extra {extra}")
    for path, (shape, _) in want.items():
        if tuple(np.shape(got[path])) != shape:
            raise ValueError(f"JAX param {'.'.join(path)} has shape {np.shape(got[path])}, "
                             f"{model.cfg.name} wants {shape}")
    for path, (_, dests) in want.items():
        arr = torch.from_numpy(np.array(got[path], dtype=np.float32))
        if path[0] in STACKED:
            for g, dest in enumerate(dests):
                dest.copy_(arr[g])
        else:
            dests[0].copy_(arr)
    return model


def param_axes(model: Model) -> dict:
    """The ``Axes`` tree of ``model``'s parameters in the JAX tree's shape
    (a leading None for the stacked G axis of ``units``/``encoder``)."""
    return shapes_and_axes(model)[1]


# 8-bit optimizer scales (``train.optimizer._quantize``): one row per row of the
# leaf's last dimension, so a stacked leaf's scales are its units' scales
# concatenated along axis 0, where every other stacked leaf stacks on a new axis
SCALES = ("m_s", "v_s")


def _port_paths(tree, prefix=()):
    """(path, leaf) of a port tree in JAX's flatten order: dict keys sorted,
    a list (the units of a stacked subtree) adding its index to the path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for g, t in enumerate(tree):
            yield from _port_paths(t, prefix + (g,))
    else:
        yield prefix, tree


def _grouped(tree) -> dict:
    """JAX leaf key ("params/units/l0/attn/wq") -> (stacked?, the port leaves
    it gathers, one a unit when stacked), in JAX's flatten order."""
    out = {}
    for path, leaf in _port_paths(tree):
        key = "/".join(str(k) for k in path if not isinstance(k, int))
        stacked = any(isinstance(k, int) for k in path)
        out.setdefault(key, (stacked, []))[1].append(leaf)
    return out


def _numpy(t) -> np.ndarray:
    if hasattr(t, "full_tensor"):          # a DTensor: its whole value (a collective)
        t = t.full_tensor()
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def jax_layout(tree) -> dict:
    """A port tree as the JAX tree's flat leaves: {key: numpy array} in
    ``jax.tree_util.tree_flatten_with_path`` order, keys joined by "/", the
    units of ``units``/``encoder`` stacked on a leading G axis (8-bit scales
    concatenated along axis 0). A DTensor leaf is gathered whole: every rank
    of its mesh calls this."""
    out = {}
    for key, (stacked, leaves) in _grouped(tree).items():
        arrs = [_numpy(t) for t in leaves]
        if not stacked:
            out[key] = arrs[0]
        elif key.rsplit("/", 1)[-1] in SCALES:
            out[key] = np.concatenate(arrs, axis=0)
        else:
            out[key] = np.stack(arrs)
    return out


def from_jax_layout(flat: dict, like, device=None, cast: bool = False):
    """The inverse of ``jax_layout``: ``flat`` {key: numpy array} into a tree
    shaped as the port tree ``like``, each leaf a tensor of the array's dtype
    (``cast``: of the ``like`` leaf's) on ``device`` (default: the ``like``
    leaf's own, the CPU for a ``meta`` leaf). Raises ValueError when the keys
    differ from ``like``'s."""
    groups = _grouped(like)
    if list(groups) != list(flat):
        missing = sorted(groups.keys() - flat.keys())
        extra = sorted(flat.keys() - groups.keys())
        raise ValueError(f"leaves do not fit: missing {missing}, extra {extra}"
                         if missing or extra else "leaves in another order")
    parts = {}
    for key, (stacked, leaves) in groups.items():
        a = np.asarray(flat[key])
        if not stacked:
            parts[key] = [a]
        elif key.rsplit("/", 1)[-1] in SCALES:
            parts[key] = np.split(a, len(leaves), axis=0)
        else:
            parts[key] = list(a)
    taken = {key: iter(arrs) for key, arrs in parts.items()}

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(t, prefix) for t in tree]
        arr = next(taken["/".join(prefix)])
        dev = device if device is not None else (
            "cpu" if tree.device.type == "meta" else tree.device)
        # a read-only array (a view of a JAX buffer) is copied: the tensor
        # may be updated in place
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        return t.to(dev, tree.dtype if cast else None)
    return build(like, ())


def flatten_jax(tree: dict, prefix: str = "") -> dict:
    """A JAX nested dict of arrays as flat leaves {key: array}, keys sorted
    and joined by "/" (``jax.tree_util.tree_flatten_with_path``'s order)."""
    out = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(flatten_jax(tree[k], key + "/"))
        else:
            out[key] = np.asarray(tree[k])
    return out


def load_jax_opt_state(model: Model, opt_state: dict) -> dict:
    """The JAX package's AdamW state for ``model``'s parameters (``adamw_init``
    or ``adamw_update``'s, a nested dict of numpy arrays) as the port's
    ``train.optimizer`` state on the model's device: ``mu`` in
    ``model.tree()``'s shape, unit g's moments from slice g, its 8-bit scales
    from its rows, and ``count``."""
    params = model.tree()
    names = sorted(opt_state["mu"]["embed"])        # the per-leaf state dict's keys

    def per_leaf(tree):
        if isinstance(tree, dict):
            return {k: per_leaf(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [per_leaf(t) for t in tree]
        return {n: tree for n in names}
    like = {"count": params["embed"], "mu": per_leaf(params)}
    return from_jax_layout(flatten_jax(opt_state), like, device=model.device)
