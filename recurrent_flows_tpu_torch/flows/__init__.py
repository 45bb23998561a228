from .ddi import data_dependent_init
from .glow import GlowStep, ListGlow, prep_glowstep_params
from .modules import ActNorm, AffineCoupling, Conv2dNorm, Conv2dZeros, InvConv, Split2d
from .realnvp2d import AutoregFlow2D, MaskedAffineCoupling, MixtureCDFFlow, RealNVP2D

__all__ = ["ActNorm", "AffineCoupling", "AutoregFlow2D", "Conv2dNorm", "Conv2dZeros",
           "GlowStep", "InvConv", "ListGlow", "MaskedAffineCoupling", "MixtureCDFFlow",
           "RealNVP2D", "Split2d", "data_dependent_init", "prep_glowstep_params"]
