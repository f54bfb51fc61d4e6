"""GenEO two-level coarse space.

Counterpart of htool_python_tpu/solvers/coarse.py:

* `GeneoCoarseSpaceDenseBuilder` solves each subdomain's generalized
  eigenproblem DAiD v = lambda Bi v on the host with scipy (`eigh` for
  'S' / 'H', `eig` otherwise; DAiD is the local Dirichlet matrix embedded
  in the overlapping subdomain, Bi the local Neumann matrix) and keeps the
  `geneo_nu` largest eigenvectors, or those above `geneo_threshold`;
* `VirtualGeneoCoarseSpaceDenseBuilder`: the user computes the vectors
  from the dense pair (DAiD, Bi) and calls `set_coarse_space`;
* `VirtualGeneoCoarseSpaceBuilder`: the matrix-free hook, whose callback
  applies the local operator with the overlap zeroed (numpy in, numpy
  out);
* `assemble_geneo_coarse_space` weights every subdomain's vectors by its
  partition of unity, extends them by zeros to global columns Z and
  orthonormalizes them;
* `GeneoCoarseOperatorBuilder` forms E = Z^H A Z through the distributed
  operator's device apply, 64 columns at a time (K1 on the card), or
  through `matvec_global` for custom Python local operators.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hmatrix.hmatrix import HMatrix


class VirtualGeneoCoarseSpaceDenseBuilder:
    """Base of the dense GenEO builders; subclass
    `compute_coarse_space(Ai, Bi)`."""

    def __init__(self, size_wo_overlap, size_with_overlap, Ai, Bi,
                 symmetry: str = "S", UPLO: str = "L",
                 geneo_nu: int = -1, geneo_threshold: float = -1.0):
        self.size_wo_overlap = int(size_wo_overlap)
        self.size_with_overlap = int(size_with_overlap)
        self.Ai = Ai  # HMatrix or dense, without or with the overlap
        self.Bi = np.asarray(Bi) if Bi is not None else None
        self.symmetry = symmetry
        self.UPLO = UPLO
        self.geneo_nu = int(geneo_nu) if geneo_nu is not None else -1
        self.geneo_threshold = (float(geneo_threshold)
                                if geneo_threshold is not None else -1.0)
        self._coarse_space = None

    def set_coarse_space(self, coarse_space) -> None:
        self._coarse_space = np.asarray(coarse_space)

    def compute_coarse_space(self, Ai, Bi) -> None:
        raise NotImplementedError


class GeneoCoarseSpaceDenseBuilder(VirtualGeneoCoarseSpaceDenseBuilder):
    """The built-in dense GenEO eigensolver (scipy on the host: the local
    problem is small and solved once, at setup)."""

    def compute_coarse_space(self, Ai, Bi) -> None:
        import scipy.linalg as sla

        if self.symmetry in ("S", "H"):
            w, v = sla.eigh(Ai, Bi)
        else:
            w, v = sla.eig(Ai, Bi)
        idx = np.argsort(w.real)[::-1]
        if self.geneo_threshold > 0:
            nb = int(np.sum(w.real > self.geneo_threshold))
        else:
            nb = max(self.geneo_nu, 0)
        self.set_coarse_space(v[:, idx[:nb]].real)


class VirtualGeneoCoarseSpaceBuilder:
    """The matrix-free GenEO hook: a subclass implements
    `compute_coarse_space(hmatrix_callback)`, where the callback applies
    the local operator DAiD with the overlap zeroed."""

    def __init__(self, size_wo_overlap, size_with_overlap, Ai,
                 geneo_nu: int = -1, geneo_threshold: float = -1.0):
        self.size_wo_overlap = int(size_wo_overlap)
        self.size_with_overlap = int(size_with_overlap)
        self.Ai = Ai
        self.geneo_nu = int(geneo_nu) if geneo_nu is not None else -1
        self.geneo_threshold = (float(geneo_threshold)
                                if geneo_threshold is not None else -1.0)
        self._coarse_space = None

    def set_coarse_space(self, coarse_space) -> None:
        self._coarse_space = np.asarray(coarse_space)

    def compute_coarse_space(self, hmatrix_callback) -> None:
        raise NotImplementedError


def _embedded_dirichlet(builder, subdomain) -> np.ndarray:
    """DAiD: the local Dirichlet matrix embedded in the overlapping
    subdomain (zeros on the ghost region).  An H-matrix Ai is densified in
    its own (cluster) order, as the reference does."""
    m = subdomain.size
    c2o = subdomain.cluster_to_ovr
    Ai = builder.Ai
    if isinstance(Ai, HMatrix):
        Ai = Ai.to_dense()
    Ai = np.asarray(Ai)
    if Ai.shape[0] == m:
        # already with the overlap: the partition of unity on both sides
        D = subdomain.partition_of_unity()
        return (D[:, None] * Ai * D[None, :]).real
    out = np.zeros((m, m), dtype=Ai.dtype)
    out[np.ix_(c2o, c2o)] = Ai
    return out.real


def _product(h: HMatrix, x, user_numbering: bool) -> np.ndarray:
    """h x for a numpy x, in h's precision on h's device (a real x is not
    promoted past h's dtype: the card has no float64 product)."""
    x = np.asarray(x)
    dtype = h.dtype
    if np.iscomplexobj(x):
        dtype = torch.promote_types(dtype, torch.complex64)
    xt = torch.as_tensor(x, device=h.device).to(dtype)
    y = h.matvec(xt) if user_numbering else h.matvec_internal(xt)
    return y.cpu().numpy()


def _make_callback(builder, subdomain):
    """The matrix-free hook's callback: numpy x (size_with_overlap) ->
    numpy DAiD x."""
    m = subdomain.size
    c2o = subdomain.cluster_to_ovr
    Ai = builder.Ai
    if isinstance(Ai, HMatrix) and Ai.shape[0] == m:
        D = subdomain.partition_of_unity()

        def callback(x):
            return _product(Ai, np.asarray(x) * D, True) * D

        return callback

    def callback(x):
        y = np.zeros(m, dtype=np.asarray(x).dtype)
        xi = np.asarray(x)[c2o]
        y[c2o] = (_product(Ai, xi, False) if isinstance(Ai, HMatrix)
                  else Ai @ xi)
        return y

    return callback


def assemble_geneo_coarse_space(solver, space_builders) -> np.ndarray | None:
    """Run every partition's builder, weight its vectors by the partition
    of unity and extend them by zeros to global columns (user numbering);
    returns Z with orthonormal columns, or None when no builder gave a
    vector."""
    n = solver.distributed_operator.shape[0]
    cols = []
    for p, builder in enumerate(space_builders):
        s = solver.subdomains[p]
        if isinstance(builder, VirtualGeneoCoarseSpaceDenseBuilder):
            DAiD = _embedded_dirichlet(builder, s)
            Bi = np.asarray(builder.Bi).real
            builder.compute_coarse_space(DAiD, Bi)
        elif isinstance(builder, VirtualGeneoCoarseSpaceBuilder):
            builder.compute_coarse_space(_make_callback(builder, s))
        else:
            raise TypeError(f"unknown coarse space builder {type(builder)}")
        v = builder._coarse_space
        if v is None or v.size == 0:
            continue
        W = s.partition_of_unity()[:, None] * v
        Zp = np.zeros((n, W.shape[1]), dtype=W.dtype)
        Zp[s.ovr_to_global] = W
        cols.append(Zp)
    if not cols:
        return None
    # orthonormal columns, for the conditioning of E
    q, r = np.linalg.qr(np.concatenate(cols, axis=1))
    d = np.abs(np.diag(r))
    return q[:, d > 1e-12 * max(d.max(), 1e-300)]


class GeneoCoarseOperatorBuilder:
    """E = Z^H A Z through the distributed operator.

    When every local operator allows the device apply, A Z runs through it
    in chunks of COLUMN_CHUNK columns (Z padded with zero columns to a
    multiple of the chunk), each chunk one product per block row (K1 on
    the card), and E reduces on the device, in the operator's dtype.
    Custom Python local operators take `matvec_global`."""

    COLUMN_CHUNK = 64

    def __init__(self, distributed_operator):
        self.distributed_operator = distributed_operator

    def build_coarse_operator(self, Z: np.ndarray) -> np.ndarray:
        A = self.distributed_operator
        Z = np.asarray(Z)
        if Z.ndim != 2:
            raise ValueError(f"Z must be 2-D, got shape {Z.shape}")
        if not A.device_apply_available():
            return Z.conj().T @ A.matvec_global(np.asarray(Z, order="F"))
        ncol = Z.shape[1]
        # the operator's own dtype: its pieces' dtypes promoted with the
        # narrowest x the apply takes (float32, or complex64 for a complex
        # Z), so an f32 operator keeps f32 columns
        dtype = A._result_dtype(np.empty(0, np.complex64 if np.iscomplexobj(Z)
                                         else np.float32))
        if ncol == 0:
            return np.zeros((0, 0), dtype=dtype)
        chunk = min(self.COLUMN_CHUNK, ncol)
        ncol_pad = -(-ncol // chunk) * chunk
        Zp = np.zeros((Z.shape[0], ncol_pad), dtype=dtype)
        Zp[:, :ncol] = Z
        Zd = torch.as_tensor(Zp, device=A.device)
        apply = A.build_device_apply()
        AZ = torch.cat([apply(Zd[:, i:i + chunk])
                        for i in range(0, ncol_pad, chunk)], dim=1)
        E = Zd.conj().T @ AZ
        return E[:ncol, :ncol].cpu().numpy()
