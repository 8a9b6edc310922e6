"""The family x backend x mesh-plan sweep.

Port of ``repro.tracecheck.matrix``: :func:`default_matrix` is the one
definition of "every hot entry point" that the CLI gate and
``chip_smoke.py``'s phase 14 iterate. A :class:`Case` is host data only
(no torch here): entry kind, problem family, backend, and for dist cases
the (pod, data) plan. Capture is :mod:`.capture`'s.

The backends are the port's: ``"plain"`` runs the case on the CPU, where
every kernel wrapper takes its plain version (the reference's ``"xla"``),
and ``"kernel"`` runs it on the card, where every wrapper launches its
CUDA kernel (the reference's ``"pallas"``). The composition and the case
names are the reference's under that mapping.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Case", "default_matrix", "BACKENDS", "FAMILIES", "KERNEL_OPS"]

BACKENDS = ("plain", "kernel")  # CPU and plain versions; the card and its kernels
FAMILIES = ("match", "vcover", "dense-sub", "gen-match")
KERNEL_OPS = ("gather", "softmax", "probe", "axpy")


@dataclass(frozen=True)
class Case:
    """One cell of the tracecheck sweep."""

    entry: str  # solve | solve_batch | solve_traced | dist | lpserve | kernel
    family: str = ""  # problem family ("" for kernel cases)
    backend: str = "plain"  # plain (CPU) | kernel (the card)
    pod: int = 1  # dist only
    data: int = 1  # dist only
    lanes: int = 4  # lpserve only
    op: str = ""  # kernel cases: gather | softmax | probe | axpy

    @property
    def name(self) -> str:
        if self.entry == "kernel":
            return f"kernel:{self.op}"
        bits = [self.entry, self.family, self.backend]
        if self.entry == "dist":
            bits.append(f"pod{self.pod}x{self.data}")
        return ":".join(bits)

    @property
    def device(self) -> str:
        """Where the case runs: the CPU for ``plain``, the card for ``kernel``."""
        return "cuda" if self.backend == "kernel" else "cpu"


def default_matrix(quick: bool = False) -> list[Case]:
    """The default sweep (``quick`` trims the families and the extra cells).

    Composition (the reference's):

    * ``solve`` per family under both backends (the card's against the
      CPU's: the backend parity proof, and cost cells of every family x
      backend);
    * one ``solve_traced`` cell (the trace's rows come from the loop's read);
    * ``solve_batch`` per family (lanes of one loop), and once on the card;
    * ``dist`` plans: identity (1, 1) per family, which the identity proof
      holds against ``solve_batch``, plus pod-sharded (2, 1) and
      data-sharded (1, 2) under both backends, over a fake process group
      in this process;
    * one ``lpserve`` engine audit per backend (every dispatch key it
      assembles);
    * each kernel wrapper on the card once (the shared-memory rule).
    """
    families = ["match", "vcover"] if quick else list(FAMILIES)
    cases: list[Case] = []

    for fam in families:
        for backend in BACKENDS:
            cases.append(Case("solve", fam, backend))
        cases.append(Case("solve_batch", fam, "plain"))
        cases.append(Case("dist", fam, "plain", pod=1, data=1))
    cases.append(Case("solve_batch", families[0], "kernel"))
    cases.append(Case("solve_traced", families[0], "plain"))

    for backend in BACKENDS:
        cases.append(Case("dist", families[0], backend, pod=2, data=1))
        cases.append(Case("dist", families[0], backend, pod=1, data=2))
    if not quick:
        cases.append(Case("dist", "gen-match", "plain", pod=2, data=1))

    cases.append(Case("lpserve", families[0], "plain"))
    if not quick:
        cases.append(Case("lpserve", "vcover", "kernel"))

    for op in KERNEL_OPS:
        cases.append(Case("kernel", op=op, backend="kernel"))
    return cases
