"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .fused import (
    AinvPlan,
    CouplingPlan,
    GatesPlan,
    actnorm_invconv,
    actnorm_invconv_ref,
    ainv_plan,
    convlstm_gates,
    convlstm_gates_ref,
    coupling_mode,
    coupling_plan,
    coupling_transform,
    coupling_transform_ref,
    gates_plan,
    nhwc_view,
)
from .glowchain import glowchain, glowchain_ref
from .glowstep import (GlowStepParams, LaunchPlan, glowstep, glowstep_ref,
                       launch_plan, plan_chunks, plan_exists, plan_samples)
from . import library  # noqa: F401  (defines the rft:: operators the wrappers call)
from .mol import (DiscretizedMixtureLogits, DiscretizedMixtureLogits1d, mol_log_prob_1d,
                  mol_log_prob_rgb, mol_sample_1d, mol_sample_rgb)

__all__ = ["AinvPlan", "CouplingPlan", "DiscretizedMixtureLogits", "DiscretizedMixtureLogits1d",
           "GatesPlan", "GlowStepParams", "LaunchPlan", "actnorm_invconv",
           "actnorm_invconv_ref", "ainv_plan", "convlstm_gates", "convlstm_gates_ref",
           "coupling_mode", "coupling_plan", "coupling_transform", "coupling_transform_ref",
           "gates_plan", "glowchain", "glowchain_ref", "glowstep", "glowstep_ref", "launch_counts",
           "launch_plan", "mol_log_prob_1d", "mol_log_prob_rgb", "mol_sample_1d",
           "mol_sample_rgb", "nhwc_view", "plan_chunks", "plan_exists", "plan_samples", "reset_launch_counts"]

_WRAPPERS = (actnorm_invconv, convlstm_gates, coupling_transform, glowchain,
             glowstep)


def launch_counts() -> dict:
    """Launches of each kernel wrapper since its count was last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
