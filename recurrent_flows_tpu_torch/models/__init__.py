from .rfn import RFN

__all__ = ["RFN"]
