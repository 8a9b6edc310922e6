from .ops import incidence_gather
