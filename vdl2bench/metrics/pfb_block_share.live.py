"""pfb_block_share.live: pfb_block_share in a live cell, whose blocks
go through ``feed``."""
from .pfb_block_share import read  # noqa: F401
