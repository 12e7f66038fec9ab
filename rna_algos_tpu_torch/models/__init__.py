from .mccaskill import mccaskill_bpp, mccaskill_bpp_batch
from .durbin import durbin_match_probs, durbin_match_probs_batch

__all__ = ["mccaskill_bpp", "mccaskill_bpp_batch", "durbin_match_probs",
           "durbin_match_probs_batch"]
