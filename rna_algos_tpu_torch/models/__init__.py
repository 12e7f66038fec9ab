from .mccaskill import mccaskill_bpp, mccaskill_bpp_batch

__all__ = ["mccaskill_bpp", "mccaskill_bpp_batch"]
