"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .fused import (
    convlstm_gates,
    convlstm_gates_ref,
    coupling_transform,
    coupling_transform_ref,
)
from .glowchain import GlowStepParams, glowchain, glowchain_ref, glowstep_ref

__all__ = ["GlowStepParams", "convlstm_gates", "convlstm_gates_ref",
           "coupling_transform", "coupling_transform_ref", "glowchain",
           "glowchain_ref", "glowstep_ref"]


def launch_counts() -> dict:
    """Launches of each kernel wrapper since its count was last reset."""
    return {"convlstm_gates": convlstm_gates.launches,
            "coupling_transform": coupling_transform.launches,
            "glowchain": glowchain.launches}


def reset_launch_counts() -> None:
    convlstm_gates.launches = 0
    coupling_transform.launches = 0
    glowchain.launches = 0
