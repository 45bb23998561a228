"""Cells of the benchmark's own configurations and traffic cut to a size the
CPU runs in seconds, for the tests: the same keys, small widths."""

from __future__ import annotations

import copy

from benchmark import harness

TINY_RFN = dict(image_size=16, L=2, K=2, h_dim=8, z_dim=2, a_dim=8,
                extractor_structure=[[4, "pool", 8], [8, "pool", 8]],
                upscaler_structure=[[8], ["upsample", 4]],
                prior_structure=[8], encoder_structure=[8])
TINY_SRNN = dict(image_size=16, h_dim=8, a_dim=8, z_dim=2)
TINY_TRAFFIC = dict(batch=2, frames=3, n_conditions=2, n_predictions=2, pool=4, warmup=1,
                    check_requests=2, trace_units=1)


def tiny_cell(workload: str, manifest=None) -> harness.Cell:
    """The manifest's cell ``workload`` with its configuration and traffic
    cut down; limits, metrics and entry as they are."""
    cell = harness.resolve(workload, manifest or harness.load_manifest())
    cell = copy.deepcopy(cell)
    model = cell.config["model"]
    if cell.config["family"] == "RFN":
        model.update(copy.deepcopy(TINY_RFN))
        model["glow"].update(L=2, K=2, n_units_affine=8, n_units_prior=8)
    else:
        model.update(TINY_SRNN)
    cell.config["train"]["batch_size"] = TINY_TRAFFIC["batch"]
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in cell.traffic
                         or k in ("batch", "pool", "trace_units")})
    return cell
