from .ops import axpy_reduce
