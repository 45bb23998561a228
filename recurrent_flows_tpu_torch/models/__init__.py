from .rfn import RFN
from .srnn import SRNN
from .svg import SVG
from .vrnn import VRNN

__all__ = ["RFN", "SRNN", "SVG", "VRNN", "split_reconstruction"]


def split_reconstruction(out) -> tuple:
    """(recons, recons_flow) of a model's ``reconstruct``: RFN's returns
    both, the reconstructions and the flow's x -> z -> x; the other
    families return the reconstructions alone, and recons_flow is None."""
    return out if isinstance(out, tuple) else (out, None)
