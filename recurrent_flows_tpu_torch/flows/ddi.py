"""Data-dependent (ActNorm) initialization, the counterpart of
``recurrent_flows_tpu.flows.ddi``.

The JAX package runs the model once in ``ddi=True`` mode, each ActNorm
computing its statistics from its own input (already normalised
upstream), using them, and sowing them into a collection that is merged
into the parameters afterwards. PyTorch runs eagerly and may update in
place, so here the same pass sets each ActNorm's ``bias``/``logs`` as it
goes, under ``torch.no_grad()``: one sweep, in the same order, with the
same values downstream.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def data_dependent_init(model, x, noise):
    """Initialise every ActNorm of ``model`` from the batch ``x``
    [B, T>=2, H, W, C] (model space) through ``model.ddi``; returns the
    pass's nll [B]."""
    return model.ddi(x, noise)
