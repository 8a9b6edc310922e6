"""Linear operators for positive LPs (paper §3 + §5.1.2), in PyTorch.

Port of ``repro.core.operators``: the implicit representations of the
constraint matrices of graph LPs, each described by its edge list.

* ``Incidence``        M  (|V| x |E|)  — matching / bmatch packing rows,
                                          transposed for vertex-cover.
* ``AdjacencyPlusId``  I+A (|V| x |V|) — dominating-set covering rows.
* ``VertexEdgePair``   O  (|V| x 2|E|) — densest-subgraph packing rows.
* ``InterweavedId``    W  (|E| x 2|E|) — densest-subgraph covering rows.

Products with an operator are scatter-adds, as the reference leaves
them to XLA's scatter. On the CPU they are ``index_add_``. On the card
they go through :func:`repro_torch.kernels.incidence_scatter`, a segmented
sum over each side's CSR form (``csr``, built once per operator at its
first card product and kept on it), which sums in a fixed order, so a
card solve repeats bit for bit; ``index_add_``'s float atomics do not.
Products with the transpose of ``Incidence`` and ``VertexEdgePair`` are
gathers and go through :func:`repro_torch.kernels.incidence_gather`, which
launches the CUDA kernel for CUDA tensors and runs its plain version on
the CPU. ``as_gather`` tells the MWU iteration when ``rmatvec`` is a
plain gather ``w[u] + w[v]``, which its step-direction kernel then
computes in registers.

Edge indices stay int32 on the device: ``index_add_``, ``index_select``
and ``index_reduce_`` take them as they are, so no int64 copy of ``u``/``v``
is built per call.

Conventions
-----------
* All operators are entrywise nonnegative (positive-LP requirement).
* ``matvec``:  (n,) -> (m,);  ``rmatvec``: (m,) -> (n,)  for an m x n op.
* ``colmax()`` returns the per-column max entry (MWU's x init);
  ``colmax(row_scale)`` returns ``max_i row_scale[i] * A[i, j]``. As in the
  reference, the implicit 0/1 operators return float32 from ``colmax()``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch

from ..kernels import incidence_gather, incidence_scatter
from ..kernels.incidence_scatter import segments

__all__ = [
    "LinOp",
    "Dense",
    "Coo",
    "Incidence",
    "AdjacencyPlusId",
    "VertexEdgePair",
    "InterweavedId",
    "Transposed",
    "ScaledRows",
    "OnesRow",
    "VStack",
    "OPS",
]


def _masked(x: torch.Tensor, mask) -> torch.Tensor:
    """x with the entries where ``mask`` is False set to 0 (mask None: x)."""
    return x if mask is None else torch.where(mask, x, 0.0)


def _scatter_max(n: int, index: torch.Tensor, src: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``out.at[index].max(src)`` with out = zeros(n) unless given."""
    if out is None:
        out = torch.zeros(n, dtype=src.dtype, device=src.device)
    return out.index_reduce_(0, index, src, "amax", include_self=True)


class LinOp:
    """Abstract nonnegative linear operator."""

    #: (rows, cols)
    shape: tuple[int, int]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def colmax(self, row_scale: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def as_gather(self, y: torch.Tensor):
        """``(u, v, w)`` with ``rmatvec(y) = w[u] + w[v]`` bit for bit, or None
        where the transposed product is not such a gather."""
        return None

    # nnz as stored (implicit ops report the implicit nonzero count)
    @property
    def nnz(self) -> int:
        raise NotImplementedError

    @property
    def T(self) -> "LinOp":
        return Transposed(self)

    def materialize(self, dtype: torch.dtype = torch.float64, device="cpu") -> torch.Tensor:
        """Dense (m, n) matrix — for tests/small problems only."""
        eye = torch.eye(self.shape[1], dtype=dtype, device=device)
        return torch.stack([self.matvec(e) for e in eye], dim=1)


@dataclass
class Dense(LinOp):
    """Explicit dense matrix (tests, tiny LPs, scipy cross-checks)."""

    mat: torch.Tensor

    @property
    def shape(self):
        return tuple(self.mat.shape)

    def matvec(self, x):
        dt = torch.promote_types(self.mat.dtype, x.dtype)
        return self.mat.to(dt) @ x.to(dt)

    def rmatvec(self, y):
        dt = torch.promote_types(self.mat.dtype, y.dtype)
        return self.mat.to(dt).T @ y.to(dt)

    def colmax(self, row_scale=None):
        m = self.mat if row_scale is None else self.mat * row_scale[:, None]
        return m.max(dim=0).values

    @property
    def nnz(self):
        return self.mat.numel()

    def materialize(self, dtype=None, device=None):
        return self.mat


@dataclass
class Coo(LinOp):
    """Padded COO: the generic explicit-sparse fallback (the "PETSc" path).

    Padding entries must carry ``val == 0`` and any in-range indices.
    """

    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    _shape: tuple[int, int] = (0, 0)

    @property
    def shape(self):
        return self._shape

    @functools.cached_property
    def csr(self):
        """(matvec's segments: by row, reading x[col]; rmatvec's: by column, reading y[row])."""
        m, n = self._shape
        return (segments(self.rows, m, n, src=self.cols, wt=self.vals),
                segments(self.cols, n, m, src=self.rows, wt=self.vals))

    def matvec(self, x):
        if x.device.type != "cpu":
            return incidence_scatter(x, self.csr[0])
        out = torch.zeros(self._shape[0], dtype=x.dtype, device=x.device)
        return out.index_add_(0, self.rows, self.vals.to(x.dtype) * x.index_select(0, self.cols))

    def rmatvec(self, y):
        if y.device.type != "cpu":
            return incidence_scatter(y, self.csr[1])
        out = torch.zeros(self._shape[1], dtype=y.dtype, device=y.device)
        return out.index_add_(0, self.cols, self.vals.to(y.dtype) * y.index_select(0, self.rows))

    def colmax(self, row_scale=None):
        v = self.vals if row_scale is None else self.vals * row_scale.index_select(0, self.rows)
        return _scatter_max(self._shape[1], self.cols, v)

    @property
    def nnz(self):
        return int(self.rows.shape[0])


@dataclass
class Incidence(LinOp):
    """Vertex-edge incidence matrix M (eq. 4): M[u, e] = 1 iff u in e.

    Stored implicitly as the edge list. Optional per-edge weights scale
    the column (both endpoints share the weight — weighted graphs).
    ``edge_mask`` zeroes padded edges.
    """

    u: torch.Tensor  # (E,) int32 endpoint 0
    v: torch.Tensor  # (E,) int32 endpoint 1
    n_vertices: int = 0
    weights: Any = None  # optional (E,)
    edge_mask: Any = None  # optional (E,) bool

    @property
    def shape(self):
        return (self.n_vertices, int(self.u.shape[0]))

    def _w(self, dtype):
        E = self.u.shape[0]
        w = torch.ones(E, dtype=dtype, device=self.u.device) if self.weights is None else self.weights.to(dtype)
        return _masked(w, self.edge_mask)

    def _weighted(self, x):
        # x * _w(x.dtype); an unweighted, unmasked operator multiplies by
        # ones, which is exact, so that E-length pass is skipped
        if self.weights is None and self.edge_mask is None:
            return x
        return x * self._w(x.dtype)

    @functools.cached_property
    def csr(self):
        """The u side's and the v side's segments (masked edges left out)."""
        E = int(self.u.shape[0])
        return tuple(segments(r, self.n_vertices, E, wt=self.weights, keep=self.edge_mask) for r in (self.u, self.v))

    def matvec(self, x):
        # y_u += x_e ; y_v += x_e  (scatter direction)
        if x.device.type != "cpu":
            return incidence_scatter(x, *self.csr)
        xw = self._weighted(x)
        out = torch.zeros(self.n_vertices, dtype=x.dtype, device=x.device)
        return out.index_add_(0, self.u, xw).index_add_(0, self.v, xw)

    def rmatvec(self, y):
        # g_e = y_u + y_v  (gather direction — the kernel's hot spot)
        return self._weighted(incidence_gather(self.u, self.v, y))

    def as_gather(self, y):
        return (self.u, self.v, y) if self.weights is None and self.edge_mask is None else None

    def colmax(self, row_scale=None):
        w = self._w(torch.float32 if row_scale is None else row_scale.dtype)
        if row_scale is None:
            return w
        return torch.maximum(row_scale.index_select(0, self.u), row_scale.index_select(0, self.v)) * w

    @property
    def nnz(self):
        return 2 * int(self.u.shape[0])


@dataclass
class AdjacencyPlusId(LinOp):
    """(I + A) for dominating set (eq. 8). Symmetric; edges stored once."""

    u: torch.Tensor
    v: torch.Tensor
    n_vertices: int = 0
    edge_mask: Any = None

    @property
    def shape(self):
        return (self.n_vertices, self.n_vertices)

    @functools.cached_property
    def csr(self):
        """Rows u reading x[v], rows v reading x[u] (masked edges left out)."""
        n, m = self.n_vertices, self.edge_mask
        return (segments(self.u, n, n, src=self.v, keep=m), segments(self.v, n, n, src=self.u, keep=m))

    def matvec(self, x):
        if x.device.type != "cpu":
            return incidence_scatter(x, *self.csr, base=x)  # x: the identity part
        xu = _masked(x.index_select(0, self.u), self.edge_mask)
        xv = _masked(x.index_select(0, self.v), self.edge_mask)
        out = x.clone()  # identity part
        return out.index_add_(0, self.u, xv).index_add_(0, self.v, xu)

    def rmatvec(self, y):
        return self.matvec(y)  # symmetric

    def colmax(self, row_scale=None):
        if row_scale is None:
            return torch.ones(self.n_vertices, dtype=torch.float32, device=self.u.device)
        # column j: entries at rows {j} ∪ N(j) -> max of row_scale there.
        su = _masked(row_scale.index_select(0, self.u), self.edge_mask)
        sv = _masked(row_scale.index_select(0, self.v), self.edge_mask)
        out = _scatter_max(self.n_vertices, self.u, sv, out=row_scale.clone())
        return _scatter_max(self.n_vertices, self.v, su, out=out)

    @property
    def nnz(self):
        return self.n_vertices + 2 * int(self.u.shape[0])


@dataclass
class VertexEdgePair(LinOp):
    """Vertex-edge-pair matrix O (eq. 14): (|V| x 2|E|).

    Column 2e   has a 1 at row u for edge e = (u, v);
    column 2e+1 has a 1 at row v. Variables z are laid out interleaved,
    matching the paper's (13)/(14); we view z as (E, 2).
    """

    u: torch.Tensor
    v: torch.Tensor
    n_vertices: int = 0
    edge_mask: Any = None

    @property
    def shape(self):
        return (self.n_vertices, 2 * int(self.u.shape[0]))

    @functools.cached_property
    def csr(self):
        """Rows u reading z[2e], rows v reading z[2e+1] (masked edges left out)."""
        E = int(self.u.shape[0])
        if 2 * E > 2**31 - 1:
            raise ValueError(f"VertexEdgePair: 2E = {2 * E} column indices do not fit int32")
        e2 = 2 * torch.arange(E, dtype=torch.int32, device=self.u.device)
        return (segments(self.u, self.n_vertices, 2 * E, src=e2, keep=self.edge_mask),
                segments(self.v, self.n_vertices, 2 * E, src=e2 + 1, keep=self.edge_mask))

    def matvec(self, z):
        if z.device.type != "cpu":
            return incidence_scatter(z, *self.csr)
        z2 = z.view(-1, 2)
        zu = _masked(z2[:, 0], self.edge_mask)
        zv = _masked(z2[:, 1], self.edge_mask)
        out = torch.zeros(self.n_vertices, dtype=z.dtype, device=z.device)
        return out.index_add_(0, self.u, zu).index_add_(0, self.v, zv)

    def rmatvec(self, y):
        # Interleaved pair gather through the incidence kernel: with
        # idx = [u0, v0, u1, v1, ...], gather(idx, idx, y) = 2*y[idx]
        # and the halving is exact in binary floating point.
        idx = torch.stack([self.u, self.v], dim=-1).reshape(-1)
        g = (0.5 * incidence_gather(idx, idx, y)).view(-1, 2)
        if self.edge_mask is not None:
            g = torch.where(self.edge_mask[:, None], g, 0.0)
        return g.reshape(-1)

    def colmax(self, row_scale=None):
        if row_scale is None:
            return torch.ones(2 * int(self.u.shape[0]), dtype=torch.float32, device=self.u.device)
        return self.rmatvec(row_scale)

    @property
    def nnz(self):
        return 2 * int(self.u.shape[0])


@dataclass
class InterweavedId(LinOp):
    """Interweaved identity W (eq. 13): (|E| x 2|E|), W[e, 2e] = W[e, 2e+1] = 1."""

    n_edges: int = 0
    edge_mask: Any = None
    device: Any = "cpu"  # where colmax() builds its ones (the op holds no other tensor)

    @property
    def shape(self):
        return (self.n_edges, 2 * self.n_edges)

    def matvec(self, z):
        return _masked(z.view(-1, 2).sum(dim=-1), self.edge_mask)

    def rmatvec(self, y):
        y = _masked(y, self.edge_mask)
        return y[:, None].expand(-1, 2).reshape(-1)

    def colmax(self, row_scale=None):
        if row_scale is None:
            return torch.ones(2 * self.n_edges, dtype=torch.float32, device=self.device)
        return self.rmatvec(row_scale)

    @property
    def nnz(self):
        return 2 * self.n_edges


@dataclass
class Transposed(LinOp):
    """Lazy transpose wrapper (vertex cover uses M^T)."""

    inner: LinOp

    @property
    def shape(self):
        m, n = self.inner.shape
        return (n, m)

    def matvec(self, x):
        return self.inner.rmatvec(x)

    def rmatvec(self, y):
        return self.inner.matvec(y)

    def colmax(self, row_scale=None):
        # columns of A^T are rows of A: colmax_j = max_i s_i A[j, i]
        return _rowmax(self.inner, row_scale)

    @property
    def nnz(self):
        return self.inner.nnz


def _rowmax(op: LinOp, col_scale):
    """max_j op[i, j] * col_scale[j] for each row i (semiring max-product)."""
    if isinstance(op, Dense):
        m = op.mat if col_scale is None else op.mat * col_scale[None, :]
        return m.max(dim=1).values
    if isinstance(op, Coo):
        v = op.vals if col_scale is None else op.vals * col_scale.index_select(0, op.cols)
        return _scatter_max(op.shape[0], op.rows, v)
    if isinstance(op, Incidence):
        w = op._w(torch.float32 if col_scale is None else col_scale.dtype)
        cw = w if col_scale is None else w * col_scale
        out = _scatter_max(op.n_vertices, op.u, cw)
        return _scatter_max(op.n_vertices, op.v, cw, out=out)
    raise NotImplementedError(f"rowmax for {type(op).__name__}")


@dataclass
class ScaledRows(LinOp):
    """diag(scale) @ inner — used to normalize b-vectors to all-ones."""

    scale: torch.Tensor  # (m,)
    inner: LinOp

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, x):
        return self.scale * self.inner.matvec(x)

    def rmatvec(self, y):
        return self.inner.rmatvec(self.scale * y)

    def as_gather(self, y):
        return None if self.inner.as_gather(y) is None else self.inner.as_gather(self.scale * y)

    def colmax(self, row_scale=None):
        s = self.scale if row_scale is None else self.scale * row_scale
        return self.inner.colmax(s)

    @property
    def nnz(self):
        return self.inner.nnz


@dataclass
class OnesRow(LinOp):
    """(1/M) * c^T as a single covering/packing row (objective embedding, §2.2)."""

    c: torch.Tensor  # (n,) nonnegative objective
    inv_bound: torch.Tensor  # 0-d tensor 1/M

    @property
    def shape(self):
        return (1, int(self.c.shape[0]))

    def matvec(self, x):
        dt = torch.promote_types(self.c.dtype, x.dtype)
        return (self.inv_bound * torch.dot(self.c.to(dt), x.to(dt))).reshape(1)

    def rmatvec(self, y):
        return self.inv_bound * self.c * y[0]

    def colmax(self, row_scale=None):
        s = self.inv_bound if row_scale is None else self.inv_bound * row_scale[0]
        return self.c * s

    @property
    def nnz(self):
        return int(self.c.shape[0])


@dataclass
class VStack(LinOp):
    """Row-stack of operators sharing a column space."""

    ops: tuple  # tuple[LinOp, ...]

    @property
    def shape(self):
        return (sum(o.shape[0] for o in self.ops), self.ops[0].shape[1])

    def matvec(self, x):
        return torch.cat([o.matvec(x) for o in self.ops])

    def rmatvec(self, y):
        out = None
        off = 0
        for o in self.ops:
            m = o.shape[0]
            r = o.rmatvec(y[off:off + m])
            out = r if out is None else out + r
            off += m
        return out

    def colmax(self, row_scale=None):
        out = None
        off = 0
        for o in self.ops:
            m = o.shape[0]
            c = o.colmax(None if row_scale is None else row_scale[off:off + m])
            out = c if out is None else torch.maximum(out, c)
            off += m
        return out

    @property
    def nnz(self):
        return sum(o.nnz for o in self.ops)


#: operator classes by name (``repro_torch.api.problem.problem_from_numpy``)
OPS = {cls.__name__: cls for cls in (Dense, Coo, Incidence, AdjacencyPlusId, VertexEdgePair, InterweavedId,
                                     Transposed, ScaledRows, OnesRow, VStack)}
