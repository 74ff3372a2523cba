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
places every leaf on one device: the one-host form of the elastic restore.
Restoring onto a sharded mesh waits for the LM partition rules.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

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
    def restore(self, step: int | None, params_like, opt_like=None, device=None):
        """Load a checkpoint into trees shaped as ``params_like`` and
        ``opt_like`` (port trees; a ``meta`` tree will do), each leaf cast to
        the like leaf's dtype and placed on ``device`` (default: the like
        leaf's, the CPU for ``meta``). Raises ValueError when the
        checkpoint's leaves are not the trees' (a checkpoint with optimizer
        state restored without ``opt_like`` too). Returns (params, opt_state,
        manifest)."""
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
        return restored["params"], restored.get("opt"), manifest


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
