from .glow_image import ConditionalGlowImage, GlowImage
from .rfn import RFN
from .srnn import SRNN
from .svg import SVG
from .vrnn import VRNN
from .vrnn1d import VRNN1D

__all__ = ["ConditionalGlowImage", "GlowImage", "RFN", "SRNN", "SVG", "VRNN", "VRNN1D",
           "split_reconstruction"]


def split_reconstruction(out) -> tuple:
    """(recons, recons_flow) of a model's ``reconstruct``: RFN's returns
    both, the reconstructions and the flow's x -> z -> x; the other
    families return the reconstructions alone, and recons_flow is None."""
    return out if isinstance(out, tuple) else (out, None)
