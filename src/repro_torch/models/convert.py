"""Carry a JAX parameter tree into the port's ``Model``, and the port's axes.

The JAX package's ``Model.init`` gives a nested dict whose ``units`` and
``encoder`` leaves carry a leading G axis (one slice a unit); the port holds
those units in an ``nn.ModuleList``. ``load_jax_params`` takes that tree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and fills the port's
module, unit g from slice g; ``param_axes`` gives the port's ``Axes`` tree in
the JAX tree's shape. Neither imports JAX.
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
