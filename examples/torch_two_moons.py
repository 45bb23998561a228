"""Two-moons flow playground on the PyTorch port, the counterpart of
``examples/two_moons.py``: trains three flows on (rotating) two-moons with
``torch.optim.Adam`` and draws their densities:

  1. RealNVP (unconditional), its samples drawn over its density;
  2. the conditional RealNVP on the rotation angle, at theta = pi/3;
  3. the autoregressive mixture-CDF flow.

The figures are numpy images (``training.plots.heatmap``) written by
``data.png.write_png``, so no matplotlib is needed: ``<out>/two_moons.png``
(the three panels side by side) and one file per panel. Runs on the card
unless asked for the CPU.

Usage: python examples/torch_two_moons.py [--steps 800] [--out runs/two_moons]
       [--device cuda|cpu] [--seed 0]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from recurrent_flows_tpu_torch.data.halfmoon import (  # noqa: E402
    RotatingTwoMoonsConditionalSampler, two_moons)
from recurrent_flows_tpu_torch.data.png import write_png  # noqa: E402
from recurrent_flows_tpu_torch.flows.realnvp2d import AutoregFlow2D, RealNVP2D  # noqa: E402
from recurrent_flows_tpu_torch.training.plots import SEPARATOR, heatmap  # noqa: E402
from recurrent_flows_tpu_torch.utils import NoiseSource  # noqa: E402

EXTENT, GRID, BATCH = 2.5, 120, 512


def train(name, model, sample_batch, steps: int, lr: float = 2e-3) -> list:
    """``steps`` Adam steps on the mean negative log-likelihood of
    ``sample_batch()`` (the arguments of ``model.log_prob``). Returns the
    losses, read from the device once at the end."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for i in range(steps):
        loss = -model.log_prob(*sample_batch()).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 200 == 0:
            print(f"  {name} step {i}: nll {float(losses[-1]):.3f}")
    return [float(v) for v in torch.stack(losses).cpu()]


@torch.no_grad()
def density_grid(log_prob, device) -> np.ndarray:
    """exp(log_prob) on a GRID x GRID grid over [-EXTENT, EXTENT]², row 0 at
    y = -EXTENT."""
    xs = np.linspace(-EXTENT, EXTENT, GRID)
    grid = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    lp = log_prob(torch.tensor(grid, dtype=torch.float32, device=device))
    return np.exp(lp.cpu().numpy()).reshape(GRID, GRID)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--out", default="runs/two_moons")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    device = torch.device(args.device)
    noise = NoiseSource(generator=torch.Generator(device=device).manual_seed(args.seed))
    init = lambda k: dict(device=device,  # noqa: E731
                          generator=torch.Generator().manual_seed(args.seed + k))
    losses, panels = {}, {}

    print("RealNVP…")
    nvp = RealNVP2D(n_couplings=6, hidden=64, **init(1))
    losses["realnvp"] = train("realnvp", nvp, lambda: (two_moons(noise, BATCH, device=device),),
                              args.steps)
    with torch.no_grad():
        samples = nvp.sample(400, noise).cpu().numpy()
    panels["realnvp"] = heatmap(density_grid(nvp.log_prob, device), samples, EXTENT)

    print("Conditional RealNVP…")
    sampler = RotatingTwoMoonsConditionalSampler(device=device)
    cnvp = RealNVP2D(n_couplings=6, hidden=64, context_dim=1, **init(2))

    def cond_batch():
        theta = noise.uniform(torch.empty((), device=device), 0.0, 2 * math.pi)
        x = sampler.conditioned_sample(noise, BATCH, theta)
        return x, theta.reshape(1, 1).expand(BATCH, 1)

    losses["conditional_realnvp"] = train("conditional realnvp", cnvp, cond_batch, args.steps)
    theta0 = math.pi / 3
    panels["conditional_realnvp"] = heatmap(density_grid(
        lambda g: cnvp.log_prob(g, torch.full((g.shape[0], 1), theta0, device=device)),
        device), extent=EXTENT)

    print("Autoregressive CDF flow…")
    ar = AutoregFlow2D(n_components=6, hidden=32, **init(3))
    losses["autoregressive"] = train("autoregressive", ar,
                                     lambda: (two_moons(noise, BATCH, device=device),),
                                     args.steps)
    panels["autoregressive"] = heatmap(density_grid(ar.log_prob, device), extent=EXTENT)

    files = []
    for name, img in panels.items():
        files.append(os.path.join(args.out, f"{name}.png"))
        write_png(files[-1], img)
    gap = np.full((GRID, 4, 3), SEPARATOR, np.uint8)
    figure = np.concatenate([panels["realnvp"], gap, panels["conditional_realnvp"], gap,
                             panels["autoregressive"]], 1)
    files.append(os.path.join(args.out, "two_moons.png"))
    write_png(files[-1], figure)
    for name, ls in losses.items():
        print(f"{name}: nll {ls[0]:.3f} -> {ls[-1]:.3f}")
    print("wrote", ", ".join(files))
    return dict(losses=losses, files=files)


if __name__ == "__main__":
    main()
