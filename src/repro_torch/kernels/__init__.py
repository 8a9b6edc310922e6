"""Hand-written CUDA kernels, one folder per kernel: the four of the MWU
hot path and the flash attention of the LM plane's encoder forward. The
line-search probe's folder also holds the Newton step-size search, which
runs the whole search over its probes in one launch (``newton_search``).
Two more carry the iteration's other work: ``incidence_scatter``, the
deterministic segmented sum behind every scatter product on the card,
and ``step_direction``, the step direction and its max in one launch.

Each folder holds ``ops.py`` (the wrapper its callers call) and ``ref.py``
(its plain PyTorch version); the CUDA sources are in ``csrc/`` and
``loader.py`` builds and binds them. A wrapper given CUDA tensors launches
its kernel or raises; given CPU tensors it runs the plain version. There is
no backend switch: the tensor's device decides.

:func:`launch_counts` reports how many times each kernel was launched on
the card since :func:`reset_launch_counts`.
"""
from .axpy_reduce import axpy_reduce
from .flash_attention import flash_attention
from .incidence_gather import incidence_gather
from .incidence_scatter import incidence_scatter
from .linesearch_probe import linesearch_probe, linesearch_probe2, newton_search
from .loader import LAUNCHES
from .softmax_weights import softmax_weights
from .step_direction import step_direction

__all__ = [
    "KERNELS",
    "axpy_reduce",
    "flash_attention",
    "incidence_gather",
    "incidence_scatter",
    "linesearch_probe",
    "linesearch_probe2",
    "newton_search",
    "softmax_weights",
    "step_direction",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "incidence_gather": ("src/repro_torch/kernels/csrc/incidence_gather.cu",
                         "src/repro/kernels/incidence_gather/kernel.py:48"),
    "softmax_weights": ("src/repro_torch/kernels/csrc/softmax_weights.cu",
                        "src/repro/kernels/softmax_weights/kernel.py:82"),
    "linesearch_probe": ("src/repro_torch/kernels/csrc/linesearch_probe.cu",
                         "src/repro/kernels/linesearch_probe/kernel.py:83"),
    "newton_search": ("src/repro_torch/kernels/csrc/linesearch_probe.cu",
                      "src/repro/core/stepsize.py:261"),
    "axpy_reduce": ("src/repro_torch/kernels/csrc/axpy_reduce.cu",
                    "src/repro/kernels/axpy_reduce/kernel.py:55"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:86"),
    # not a Pallas kernel: the reference's XLA scatter-add of Incidence.matvec
    "incidence_scatter": ("src/repro_torch/kernels/csrc/incidence_scatter.cu",
                          "src/repro/core/operators.py:226"),
    # the gather fused with the iteration's step direction and its max
    "step_direction": ("src/repro_torch/kernels/csrc/step_direction.cu",
                       "src/repro/kernels/incidence_gather/kernel.py:48 + src/repro/core/mwu.py:182-185"),
}


def launch_counts() -> dict[str, int]:
    """Launches on the card per kernel since the last reset."""
    return {name: LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
