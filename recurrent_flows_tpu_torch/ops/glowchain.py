"""K GlowSteps of one flow scale in one launch: the CUDA C++ kernel
``csrc/glowchain.cu`` beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/glowchain.py::_glowchain_pallas``
(``glowchain.py:84``). The source notes in ``csrc/glowchain.cu`` and
``csrc/glowstep_body.cuh`` say what bounds it on the H100 and what its
design does about that; ``ops.glowstep.launch_plan`` decides its launch
geometry.

Parameters arrive as a :class:`GlowStepParams` whose every leaf is stacked
``[K, ...]`` in execution order (reversed for the inverse), as
``flows.glow.ListGlow.chain_params`` builds them. The wrapper dispatches by
device: a CPU tensor takes :func:`glowchain_ref`, a CUDA tensor launches
the kernel or raises. It counts its launches in ``glowchain.launches``.
The gradient on the card re-runs the plain chain on the saved inputs
(``ops.glowstep.ReplayGrad``), as the TPU kernel's VJP does.
"""

from __future__ import annotations

import torch

from .glowstep import (CLAMP_TYPES, GlowStepParams, ReplayGrad, check_inputs,
                       glowstep_ref, launch_kernel)


def glowchain_ref(x, cond, ps: GlowStepParams, clamp_type: str,
                  reverse: bool):
    """Plain version: ``glowstep_ref`` looped over the K stacked steps.
    Returns (y, summed coupling logdet [B])."""
    ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(ps.wa.shape[0]):
        x, ldk = glowstep_ref(x, cond, GlowStepParams(*(a[k] for a in ps)),
                              clamp_type, reverse)
        ld = ld + ldk
    return x, ld


def _launch(x, cond, ps, clamp_type, reverse):
    out = launch_kernel("glowchain", x, cond, ps,
                        (ps.wa.shape[0], CLAMP_TYPES[clamp_type], int(reverse)))
    glowchain.launches += 1
    return out


def glowchain(x, cond, ps: GlowStepParams, clamp_type: str, reverse: bool):
    """Whole-scale K-step chain: (y, dyn_logdet[B]), NHWC f32."""
    if clamp_type not in CLAMP_TYPES:
        raise ValueError(f"unknown clamp type: {clamp_type}")
    if not check_inputs("glowchain", x, cond, ps, stacked=True):
        return glowchain_ref(x, cond, ps, clamp_type, reverse)
    return ReplayGrad.apply(_launch, glowchain_ref, clamp_type, reverse,
                            x, cond, *ps)


glowchain.launches = 0
