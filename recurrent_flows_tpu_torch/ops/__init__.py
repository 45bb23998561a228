"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .fused import (
    actnorm_invconv,
    actnorm_invconv_ref,
    convlstm_gates,
    convlstm_gates_ref,
    coupling_transform,
    coupling_transform_ref,
)
from .glowchain import glowchain, glowchain_ref
from .glowstep import (GlowStepParams, LaunchPlan, glowstep, glowstep_ref,
                       launch_plan, plan_chunks, plan_samples)

__all__ = ["GlowStepParams", "LaunchPlan", "actnorm_invconv", "actnorm_invconv_ref",
           "convlstm_gates", "convlstm_gates_ref", "coupling_transform",
           "coupling_transform_ref", "glowchain", "glowchain_ref", "glowstep",
           "glowstep_ref", "launch_counts", "launch_plan", "plan_chunks", "plan_samples",
           "reset_launch_counts"]

_WRAPPERS = (actnorm_invconv, convlstm_gates, coupling_transform, glowchain,
             glowstep)


def launch_counts() -> dict:
    """Launches of each kernel wrapper since its count was last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
