"""Scenario, on the PyTorch/CUDA port: fault tolerance end-to-end — crash
mid-run, restart, verify the continuation; then restore the same checkpoint
onto another device (the one-host form of the elastic path).

  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py                # on the card
  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py --device cpu

The counterpart of ``examples/fault_tolerance_demo.py``: the same two
launcher runs (``repro_torch.launch.train``, a crash after step 6, then a
restart from the same --ckpt). Its elastic step restores the run's last
checkpoint onto the CPU and holds it leaf for leaf against the checkpoint's
arrays; the JAX example's restore onto an 8-device sharded mesh waits for
the LM partition rules (ROADMAP §1.4.2).
"""
import argparse
import os
import subprocess
import sys
import tempfile
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the training runs (default cuda)")
dev = ap.parse_args().device


def run(args):
    return subprocess.run([sys.executable, "-m"] + args + ["--device", dev], env=ENV,
                          cwd=ROOT, capture_output=True, text=True)


with tempfile.TemporaryDirectory() as d:
    ck = os.path.join(d, "ck")
    print("[ft] run 1: training with an injected crash at step 6 ...")
    r1 = run(["repro_torch.launch.train", "--arch", "qwen3-0.6b", "--steps", "12",
              "--batch", "2", "--seq", "32", "--ckpt", ck,
              "--ckpt-every", "4", "--inject-failure", "6"])
    assert r1.returncode == 17, "expected the injected crash:\n" + r1.stderr[-1000:]
    tail = [ln for ln in r1.stdout.splitlines()
            if ln.startswith("[train] step")]
    print("   last steps before crash:", tail[-2:])

    print("[ft] run 2: restart from the same --ckpt ...")
    r2 = run(["repro_torch.launch.train", "--arch", "qwen3-0.6b", "--steps", "12",
              "--batch", "2", "--seq", "32", "--ckpt", ck,
              "--ckpt-every", "4"])
    assert r2.returncode == 0, r2.stderr[-1000:]
    lines = [ln for ln in r2.stdout.splitlines() if "restored" in ln
             or ln.startswith("[train] step")]
    print("   " + "\n   ".join(lines[:3]))
    print("[ft] crash/restart: OK (resumed from the last checkpoint)")

    print(f"[ft] elastic restore of the {dev} run's checkpoint onto the CPU ...")
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.convert import jax_layout
    from repro_torch.models.transformer import Model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, adamw_init, tree_leaves
    cm = CheckpointManager(ck)
    like = Model(get_arch("qwen3-0.6b").smoke_config, device="meta").tree()
    params, opt, man = cm.restore(None, like, adamw_init(like, OptConfig()), device="cpu")
    saved = np.load(os.path.join(ck, f"step_{man['step']}", "arrays.npz"))
    got = jax_layout({"params": params, "opt": opt})
    assert list(got) == man["keys"], "restored leaves are not the checkpoint's"
    assert all(np.array_equal(got[k], saved[f"a{i}"]) for i, k in enumerate(man["keys"])), \
        "restored leaves differ from the checkpoint's arrays"
    assert all(t.device == torch.device("cpu") for t in tree_leaves([params, opt]))
    print(f"[ft] elastic restore onto cpu at step {man['step']}: {len(man['keys'])} leaves "
          "equal to the checkpoint's, OK")
    print("[ft] elastic restore onto an 8-device sharded mesh: waits for the LM "
          "partition rules (ROADMAP §1.4.2)")
print("[ft] all fault-tolerance paths verified")
