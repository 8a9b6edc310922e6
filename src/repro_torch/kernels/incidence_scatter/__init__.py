from .csr import MERGE_TILE, Segments, dispatch_order, segments
from .ops import incidence_scatter
