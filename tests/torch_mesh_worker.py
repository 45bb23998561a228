"""One rank of the (data x model) grid checks of ``test_torch_mesh.py``
(gloo, on the CPU):

    python tests/torch_mesh_worker.py <rank> <world> <n_model> <store file> <dir>

Reads ``<dir>/case.pt``: ``steps`` (per name: the family, its config and
train config, the initial state, the global batch, the step's global
draws, beta, lr, remat) and ``adjoints`` (whether this grid checks the
collectives). Joins the group, makes the grid with ``make_mesh`` and per
step builds a ``Trainer`` on it (no data-dependent init) and takes one
step on its batch slice with the global draws replayed; writes
``<dir>/<name>_rank<r>.pt`` (metrics, state, the reduced gradients, the
exchanges the step counted and the coupling nets it ran channel-major and
NHWC). With ``adjoints``, writes
``<dir>/adjoints_rank<r>.pt``: for ``halo`` (both sides and top only),
``gather_rows`` and ``model_sum`` the largest forward error against the
slice of the padded global tensor, and the two sides of the dot-product
test <f(x), y> = <x, f^T(y)>, each summed over the ranks (float64).
Last, ``spatial_constraint`` on frames whose height does not divide.
"""

import sys
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.nn.functional as F

from recurrent_flows_tpu_torch import models
from recurrent_flows_tpu_torch.flows import AffineCoupling
from recurrent_flows_tpu_torch.parallel import make_mesh, spatial_constraint
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource


def _summed(v: torch.Tensor) -> float:
    v = v.detach().clone().reshape(1)
    dist.all_reduce(v)
    return float(v)


def adjoints(mesh) -> dict:
    """The collectives against their definitions on one global tensor."""
    torch.manual_seed(0)  # the same global x on every rank
    b, h, w, c = 2, 4 * mesh.n_model, 6, 3
    x_all = torch.randn(b, h, w, c, dtype=torch.float64)
    mesh.frame = (h, w)
    per = h // mesh.n_model
    m = mesh.model_index
    x = x_all[:, m * per:(m + 1) * per].clone().requires_grad_(True)
    padded = F.pad(x_all, (0, 0, 0, 0, 1, 1))
    out = {}
    gen = torch.Generator().manual_seed(100 + mesh.rank)  # a cotangent per rank
    cases = {
        "halo": (lambda t: mesh.halo(t, 1, 1), padded[:, m * per:m * per + per + 2]),
        "halo_top": (lambda t: mesh.halo(t, 1, 0), padded[:, m * per:m * per + per + 1]),
        "gather_rows": (mesh.gather, x_all),
        "model_sum": (mesh.model_sum, sum(x_all[:, k * per:(k + 1) * per]
                                          for k in range(mesh.n_model))),
    }
    for name, (f, want) in cases.items():
        y_out = f(x)
        y = torch.randn(y_out.shape, dtype=torch.float64, generator=gen)
        (g,) = torch.autograd.grad(y_out, x, y)
        out[name] = dict(forward_err=float((y_out - want).abs().max()),
                         lhs=_summed((y_out * y).sum()), rhs=_summed((x * g).sum()))
    try:
        spatial_constraint(mesh, torch.zeros(2, 3, 4 * mesh.n_model + 2, 8, 1))
        out["validation"] = "no error"
    except ValueError as e:
        out["validation"] = str(e)
    return out


def step(mesh, c) -> dict:
    model = getattr(models, c["family"])(c["config"], device="cpu", remat=c["remat"])
    model.load_state_dict(c["state"])
    tr = Trainer(model, c["tcfg"], [c["batch"]], device="cpu", dp=mesh).build(run_ddi=False)
    mesh.reset_counts()
    before = AffineCoupling.channel_major_runs, AffineCoupling.nhwc_runs
    metrics = tr.train_step(mesh.local(c["batch"]), c["beta"], c["lr"],
                            noise=NoiseSource(replay=c["draws"]))
    couplings = dict(channel_major=AffineCoupling.channel_major_runs - before[0],
                     nhwc=AffineCoupling.nhwc_runs - before[1])
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=tr.model.state_dict(), counts=dict(mesh.counts), couplings=couplings,
                grads={n: p.grad for n, p in tr.model.named_parameters()
                       if p.grad is not None})


def main(rank: int, world: int, n_model: int, store: str, folder: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=120))
    mesh = make_mesh(n_model=n_model, device="cpu")
    case = torch.load(f"{folder}/case.pt", weights_only=False)
    if case["adjoints"]:
        torch.save(adjoints(mesh), f"{folder}/adjoints_rank{rank}.pt")
    for name, c in case["steps"].items():
        torch.save(step(mesh, c), f"{folder}/{name}_rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]), *sys.argv[4:6])
