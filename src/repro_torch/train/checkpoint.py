"""Step-granular checkpointing in the JAX package's format.

Layout:  <dir>/step_<N>/
            manifest.json        leaf keys, step, data-pipeline state, extra
            arrays.npz           one entry per flattened leaf, a0, a1, ...

The counterpart of ``repro.train.checkpoint``: the same files, the leaves
in ``jax.tree_util.tree_flatten_with_path`` order of ``{"params": ...,
"opt": ...}`` (dict keys sorted at every level, so ``opt/...`` comes before
``params/...``), the units of ``units``/``encoder`` stacked on a leading G
axis at save and split at restore (``models.convert.jax_layout``), so each
package restores the other's checkpoints. Writes are atomic (tmp dir +
rename); ``keep_last`` old steps are pruned. ``restore(..., device=)``
places every leaf on one device; ``restore(..., mesh=, param_shardings=,
opt_shardings=)`` places each leaf on the mesh under its sharding (each
rank keeps its block): the elastic path, onto a mesh of any shape. Trees of
DTensors save whole: every rank of their mesh calls ``save`` (the leaves
are gathered), and rank 0 writes.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import distribute
from repro_torch.models.convert import from_jax_layout, jax_layout


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state=None, data_state=None,
             extra: dict | None = None) -> str:
        """Write ``params`` (a port tree: ``Model.tree()``) and ``opt_state``."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt"] = opt_state
        flat = jax_layout(tree)
        final = os.path.join(self.dir, f"step_{step}")
        if dist.is_initialized() and dist.get_rank() != 0:
            dist.barrier()                   # rank 0 writes
            return final
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": v for i, v in enumerate(flat.values())})
        manifest = {
            "step": step,
            "keys": list(flat),
            "time": time.time(),
            "has_opt": opt_state is not None,
            "data_state": data_state or {},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._prune()
        if dist.is_initialized():
            dist.barrier()
        return final

    def _prune(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # --------------------------------------------------------------- restore
    def restore(self, step: int | None, params_like, opt_like=None, device=None,
                mesh=None, param_shardings=None, opt_shardings=None):
        """Load a checkpoint into trees shaped as ``params_like`` and
        ``opt_like`` (port trees; a ``meta`` tree will do), each leaf cast to
        the like leaf's dtype and placed on ``device`` (default: the like
        leaf's, the CPU for ``meta``). With ``mesh``, each leaf then becomes a
        DTensor under its ``param_shardings`` / ``opt_shardings`` leaf
        (NamedSharding trees shaped as the like trees), each rank keeping its
        block. Raises ValueError when the checkpoint's leaves are not the
        trees' (a checkpoint with optimizer state restored without
        ``opt_like`` too). Returns (params, opt_state, manifest)."""
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            flat = {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}
        tree = {"params": params_like}
        if opt_like is not None:
            tree["opt"] = opt_like
        restored = from_jax_layout(flat, tree, device=device, cast=True)
        params, opt = restored["params"], restored.get("opt")
        if mesh is not None:
            params = _placed(params, param_shardings)
            opt = None if opt is None else _placed(opt, opt_shardings)
        return params, opt, manifest


def _placed(tree, shardings):
    """Each leaf of ``tree`` as a DTensor under the matching sharding."""
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_placed(t, s) for t, s in zip(tree, shardings)]
    return distribute(tree, shardings)


def assign_(dst, src) -> None:
    """Copy every leaf of the tree ``src`` into the same leaf of ``dst``, in
    place (a restored checkpoint into a model's parameters and its state)."""
    with torch.no_grad():
        for key in dst:
            if isinstance(dst[key], dict):
                assign_(dst[key], src[key])
            elif isinstance(dst[key], list):
                for a, b in zip(dst[key], src[key]):
                    assign_(a, b)
            else:
                dst[key].copy_(src[key])
