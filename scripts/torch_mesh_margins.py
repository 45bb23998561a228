"""The float32 margins behind the tolerances of ``tests/test_torch_mesh.py``
(on the CPU, with JAX; about two minutes):

1. the port's one-process train step against JAX's at the test's 16x16
   size, no grid at all: the relative difference of each metric and the
   largest gradient difference as a fraction of the model's largest
   gradient (with its parameter);
2. SRNN, VRNN and SVG on a 1x2 grid (two gloo processes of
   ``tests/torch_mesh_worker.py``) against their one-process steps: the
   largest gradient difference as a fraction of the model's largest.

    JAX_PLATFORMS=cpu python scripts/torch_mesh_margins.py
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_mesh as M  # noqa: E402
from recurrent_flows_tpu.data import MovingMNIST  # noqa: E402
from recurrent_flows_tpu_torch.utils import NoiseSource  # noqa: E402
from test_rfn import tiny_cfg  # noqa: E402


def worst(got: dict, ref: dict):
    """(largest |got - ref| over the model's largest |ref|, its name)."""
    g_max = max(float(g.abs().max()) for g in ref.values())
    return max((float((got[n] - g).abs().max()) / g_max, n) for n, g in ref.items() if n in got)


def main() -> None:
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        batch = np.asarray(MovingMNIST(seq_len=M.T, image_size=16, digit_size=8,
                                       num_digits=1).sample(jax.random.key(42), M.B))
        j = M._jax_step(tiny_cfg(norm_type_features="batchnorm"), batch, tmp / "jax")
        p = M._port_step(j["model"], j["tcfg"], batch, NoiseSource(replay=j["draws"]))
        rel = {k: abs(p["metrics"][k] - v) / abs(v) for k, v in j["metrics"].items()}
        print("one process against JAX, relative metric differences:",
              {k: f"{v:.2e}" for k, v in rel.items()})
        print("  largest gradient difference of the model's largest: %.2e (%s)"
              % worst(p["grads"], j["grads"]))
        rng = np.random.default_rng(0)
        refs, steps = {}, {}
        for i, family in enumerate(("SRNN", "VRNN", "SVG")):
            b = rng.random((M.B, M.T, 16, 16, 1), np.float32)
            r = refs[family] = M._family_step(family, b, 10 * i)
            steps[family] = dict(family=family, config=r["cfg"], tcfg=r["tcfg"], state=r["state"],
                                 batch=torch.tensor(b), draws=r["draws"], beta=M.BETA, lr=M.LR,
                                 remat=True)
        torch.save(dict(steps=steps, adjoints=False), tmp / "case.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
        procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"),
                                   str(r), "2", "2", str(tmp / "store"), str(tmp)], env=env)
                 for r in range(2)]
        if any(proc.wait(timeout=600) for proc in procs):
            raise SystemExit("a grid rank failed")
        for family, r in refs.items():
            got = torch.load(tmp / f"{family}_rank0.pt", weights_only=False)
            print("%s on 1x2 against one process: largest gradient difference of the model's "
                  "largest %.2e (%s)" % ((family,) + worst(got["grads"], r["grads"])))


if __name__ == "__main__":
    main()
