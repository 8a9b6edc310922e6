from .csr import MERGE_TILE, Segments, segments
from .ops import incidence_scatter
