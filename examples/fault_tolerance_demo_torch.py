"""Scenario, on the PyTorch/CUDA port: fault tolerance end-to-end — crash
mid-run, restart, verify the continuation; then restore the same checkpoint
onto another device, and onto a sharded mesh (the elastic path).

  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py                # on the card
  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py --device cpu

The counterpart of ``examples/fault_tolerance_demo.py``: the same two
launcher runs (``repro_torch.launch.train``, a crash after step 6, then a
restart from the same --ckpt). Its elastic steps restore the run's last
checkpoint onto the CPU, held leaf for leaf against the checkpoint's
arrays, and, as the JAX example does, onto a (4, 2) ('data', 'model') mesh:
in a subprocess on an 8-rank fake process group, each leaf a DTensor under
the LM partition rules, rank 0's blocks of their shardings' shapes and
equal to their slices of the checkpoint.
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

    print("[ft] elastic restore onto a different mesh (8 fake devices) ...")
    script = (
        "import torch\n"
        "from torch.distributed.tensor import distribute_tensor\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.launch.dryrun import fake_world\n"
        "from repro_torch.launch.mesh import device_mesh\n"
        "from repro_torch.models.transformer import Model\n"
        "from repro_torch.train.checkpoint import CheckpointManager\n"
        "from repro_torch.train.optimizer import OptConfig, tree_leaves\n"
        "from repro_torch.train.train_step import ShardedTrainStep\n"
        "fake_world(8)\n"
        "mesh = device_mesh((4, 2), ('data', 'model'), 'cpu')\n"
        "model = Model(get_arch('qwen3-0.6b').smoke_config, device='cpu')\n"
        "step = ShardedTrainStep(model, mesh, opt_cfg=OptConfig())\n"
        "opt = step.init_state()\n"
        f"cm = CheckpointManager({ck!r})\n"
        "whole, _, man = cm.restore(None, model.tree(), opt, device='cpu')\n"
        "params, _, _ = cm.restore(None, model.tree(), opt, mesh=mesh,\n"
        "                          param_shardings=step.param_shardings,\n"
        "                          opt_shardings=step.opt_shardings)\n"
        "for p, w, sh in zip(tree_leaves(params), tree_leaves(whole),\n"
        "                    tree_leaves(step.param_shardings)):\n"
        "    assert tuple(p.to_local().shape) == sh.shard_shape(tuple(w.shape))\n"
        "    want = distribute_tensor(w, mesh, sh.placements, src_data_rank=None)\n"
        "    assert torch.equal(p.to_local(), want.to_local())\n"
        "shape = dict(zip(mesh.mesh_dim_names, mesh.shape))\n"
        "print('[ft] elastic restore onto', shape, 'at step', man['step'], 'OK')\n")
    r3 = subprocess.run([sys.executable, "-c", script], env=ENV, cwd=ROOT,
                        capture_output=True, text=True)
    assert r3.returncode == 0, r3.stderr[-1000:]
    print("   " + r3.stdout.strip().splitlines()[-1])
print("[ft] all fault-tolerance paths verified")
