from .cloudsc2_kernel import (
    BLOCK_COLS,
    Cloudsc2BlockedOutputs,
    cloudsc2_pallas,
    unblock_outputs,
)
from .tlad_kernel import (
    cloudsc2_pallas_ad,
    cloudsc2_pallas_tl,
)

__all__ = [
    "BLOCK_COLS",
    "cloudsc2_pallas",
    "cloudsc2_pallas_tl",
    "cloudsc2_pallas_ad",
    "Cloudsc2BlockedOutputs",
    "unblock_outputs",
]
