from .ddi import data_dependent_init
from .glow import GlowStep, ListGlow, prep_glowstep_params
from .modules import ActNorm, AffineCoupling, Conv2dNorm, Conv2dZeros, InvConv, Split2d

__all__ = ["ActNorm", "AffineCoupling", "Conv2dNorm", "Conv2dZeros",
           "GlowStep", "InvConv", "ListGlow", "Split2d",
           "data_dependent_init", "prep_glowstep_params"]
