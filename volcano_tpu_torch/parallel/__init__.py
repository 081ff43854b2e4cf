from ..ops.unified import (NODE_AXIS, make_mesh, place_blocks_unified,
                           place_scan_unified)
from .mesh import place_blocks_sharded

__all__ = ["NODE_AXIS", "make_mesh", "place_blocks_sharded",
           "place_blocks_unified", "place_scan_unified"]
