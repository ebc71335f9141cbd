"""CSR (compressed sparse row) host container with binary cache.

Reference parity: format::csr_t with from_coo and read_binary/write_binary
(/root/reference/include/gunrock/formats/csr.hxx:79-240). The binary cache here
is a .npz (versioned) instead of a raw struct dump — portable and mmap-able.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from essentials_tpu import dtypes
from essentials_tpu.errors import throw_if
from essentials_tpu.formats.coo import Coo, pair_order

_BINARY_VERSION = 1


@dataclass
class Csr:
    n_rows: int
    n_cols: int
    row_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtypes.edge_dtype))
    col_indices: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.vertex_dtype))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.weight_dtype))

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    def __post_init__(self):
        self.row_offsets = np.asarray(self.row_offsets, dtype=dtypes.edge_dtype)
        self.col_indices = np.asarray(self.col_indices, dtype=dtypes.vertex_dtype)
        self.values = np.asarray(self.values)
        throw_if(self.row_offsets.shape[0] != self.n_rows + 1,
                 "csr: row_offsets must have n_rows+1 entries")

    @classmethod
    def from_coo(cls, coo: Coo, sort_columns: bool = True) -> "Csr":
        """Build CSR from COO (reference: csr_t::from_coo, csr.hxx:79-158).

        Vectorized host build: bincount degrees -> cumsum offsets -> stable
        sort scatter. Columns within each row are sorted ascending when
        ``sort_columns`` (needed by intersection-based algorithms like TC).
        """
        order = (pair_order(coo.row_indices, coo.col_indices, coo.n_cols)
                 if sort_columns
                 else np.argsort(coo.row_indices, kind="stable"))
        rows = coo.row_indices[order]
        degrees = np.bincount(rows, minlength=coo.n_rows).astype(dtypes.edge_dtype)
        offsets = np.zeros(coo.n_rows + 1, dtype=dtypes.edge_dtype)
        np.cumsum(degrees, out=offsets[1:])
        return cls(coo.n_rows, coo.n_cols, offsets,
                   coo.col_indices[order], coo.values[order])

    def to_coo(self) -> Coo:
        rows = np.repeat(
            np.arange(self.n_rows, dtype=dtypes.vertex_dtype),
            np.diff(self.row_offsets).astype(np.int64),
        )
        return Coo(self.n_rows, self.n_cols, rows, self.col_indices, self.values)

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    # -- binary cache (reference: read_binary/write_binary, csr.hxx:159-240) --

    def write_binary(self, path) -> None:
        np.savez(path, version=_BINARY_VERSION,
                 n_rows=self.n_rows, n_cols=self.n_cols,
                 row_offsets=self.row_offsets, col_indices=self.col_indices,
                 values=self.values)

    @classmethod
    def read_binary(cls, path) -> "Csr":
        with np.load(path) as z:
            throw_if(int(z["version"]) != _BINARY_VERSION,
                     f"csr binary cache version mismatch at {path}")
            return cls(int(z["n_rows"]), int(z["n_cols"]),
                       z["row_offsets"], z["col_indices"], z["values"])
