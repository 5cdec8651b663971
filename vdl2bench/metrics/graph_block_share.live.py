"""graph_block_share.live: graph_block_share in a live cell, whose
blocks go through ``feed`` (two block lengths there: two keys)."""
from .graph_block_share import read  # noqa: F401
