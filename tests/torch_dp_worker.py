"""One rank of the two-process data-parallel check of
``test_torch_distributed.py`` (gloo, on the CPU):

    python tests/torch_dp_worker.py <rank> <world> <store file> <dir>

Reads ``<dir>/case.pt`` (per family: config, initial state, the global
batch, the recorded init and step draws, beta, lr), joins the group through
``parallel.initialize``, builds a ``Trainer`` with the data-parallel state
and takes one step on its slice of the global batch, with the global draws
sliced alike; writes ``<dir>/<family>_rank<r>.pt`` (metrics, state, the
averaged gradients). Then
trains the tiny RFN CLI with ``--multigpu`` into ``<dir>/cli_rank<r>`` and
writes the trained state to ``<dir>/cli_rank<r>.pt``, which the test keeps
outside the run's folder.
"""

import sys

import torch

from recurrent_flows_tpu_torch import models
from recurrent_flows_tpu_torch.cli import main_rfn
from recurrent_flows_tpu_torch.parallel import initialize
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource


def main(rank: int, world: int, store: str, folder: str) -> None:
    torch.set_num_threads(2)
    dp = initialize("cpu", init_method=f"file://{store}", world_size=world, rank=rank)
    case = torch.load(f"{folder}/case.pt", weights_only=False)
    for family, c in case["families"].items():
        model = getattr(models, family)(c["config"], device="cpu")
        model.load_state_dict(c["state"])
        tr = Trainer(model, c["tcfg"], [c["batch"]], device="cpu", dp=dp).build(
            run_ddi=c["run_ddi"], noise=NoiseSource(replay=c["init_draws"]))
        local = dp.local(c["batch"])
        draws = [dp.local(d) for d in c["step_draws"]]
        metrics = tr.train_step(local, c["beta"], c["lr"], noise=NoiseSource(replay=draws))
        torch.save(dict(metrics={k: float(v) for k, v in metrics.items()},
                        state=tr.model.state_dict(),
                        grads={n: p.grad for n, p in tr.model.named_parameters()
                               if p.grad is not None}), f"{folder}/{family}_rank{rank}.pt")
    tr = main_rfn.main(case["cli_argv"] + ["--multigpu", "--device", "cpu",
                                            "--path", f"{folder}/cli_rank{rank}"])
    torch.save(dict(state=tr.model.state_dict(), losses=tr.losses),
               f"{folder}/cli_rank{rank}.pt")
    dp.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
