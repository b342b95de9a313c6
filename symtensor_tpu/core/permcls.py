"""PermClsSymmetricTensor — per-σ-class storage with scalar compression.

The reference's flagship format (symtensor/permcls_symtensor.py:539): one
1-D array *or a single scalar* per permutation class. A scalar class stores
tensors like "c₁ on the diagonal, c₂ elsewhere" in O(#classes) memory
(permcls_symtensor.py:79,178-193).

Accelerator adaptation: the per-class arrays are pytree leaves ordered by the
canonical σ-class enumeration; scalar compression = a 0-d leaf, which is part
of the static pytree structure (so jit caches one executable per compression
pattern — SURVEY.md §7 "static-shape discipline"). Per-class value order is
the gflat storage order restricted to the class, making permcls ↔ flat
conversions static gather/scatters.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import combinatorics as comb
from .base import SymmetricTensor, default_dtype
from .flat import FlatSymmetricTensor


@jax.tree_util.register_pytree_node_class
class PermClsSymmetricTensor(SymmetricTensor):
    format = "permcls"

    def __init__(
        self,
        rank: Optional[int] = None,
        dim: Optional[int] = None,
        data=None,
        dtype=None,
    ):
        """`data` may be:
        - None: all classes scalar-compressed to 0 (allocation-light, the
          analog of the reference's data-free planning tensors, base.py:814)
        - a scalar: every class scalar-compressed to that value
        - a dict {σ-label or counts: scalar or (s_σ,) array}
        - a dense array (symmetry checked): use from_dense for options
        """
        if rank is None or dim is None:
            if isinstance(data, (np.ndarray, jnp.ndarray)) and getattr(
                data, "ndim", 0
            ) > 0:
                rank = data.ndim
                dim = data.shape[0]
            else:
                raise ValueError("need rank and dim")
        rank, dim = int(rank), int(dim)
        dtype = dtype or default_dtype()
        keys = _class_keys(rank, dim)

        if data is None:
            store = {k: jnp.zeros((), dtype=dtype) for k in keys}
        elif isinstance(data, dict):
            store = {}
            given = {comb.as_class_counts(k): v for k, v in data.items()}
            for k in given:
                if k not in keys:
                    raise ValueError(
                        f"σ-class {comb.class_label(k)} invalid for rank "
                        f"{rank} dim {dim}"
                    )
            for k in keys:
                if k in given:
                    v = jnp.asarray(given[k], dtype=dtype)
                    s = comb.class_size(k, dim)
                    if v.ndim == 0:
                        store[k] = v
                    elif v.shape == (s,):
                        store[k] = v
                    else:
                        raise ValueError(
                            f"class {comb.class_label(k)} needs a scalar or "
                            f"shape ({s},); got {v.shape}"
                        )
                else:
                    store[k] = jnp.zeros((), dtype=dtype)
        elif np.ndim(data) == 0:
            store = {
                k: jnp.asarray(data, dtype=dtype).reshape(()) for k in keys
            }
        else:
            arr = jnp.asarray(data, dtype=dtype)
            if arr.ndim != rank or (rank and arr.shape[0] != dim):
                raise ValueError(
                    f"dense data shape {arr.shape} incompatible with "
                    f"rank {rank} dim {dim}"
                )
            store = PermClsSymmetricTensor.from_dense(arr).data

        self.rank = rank
        self.dim = dim
        self.data = store

    # ------------------------------------------------------------- pytree

    def tree_flatten(self):
        keys = tuple(self.data.keys())
        return tuple(self.data[k] for k in keys), (self.rank, self.dim, keys)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj.rank, obj.dim, keys = aux
        obj.data = dict(zip(keys, leaves))
        return obj

    @classmethod
    def _raw(cls, rank: int, dim: int, data: Dict) -> "PermClsSymmetricTensor":
        obj = object.__new__(cls)
        obj.rank, obj.dim, obj.data = rank, dim, data
        return obj

    # ------------------------------------------------------------ creation

    @classmethod
    def from_dense(
        cls, arr, symmetrize: bool = False, check: bool = True
    ) -> "PermClsSymmetricTensor":
        flat = FlatSymmetricTensor.from_dense(
            arr, symmetrize=symmetrize, check=check
        )
        return cls.from_flat(flat)

    @classmethod
    def from_flat(cls, flat: FlatSymmetricTensor) -> "PermClsSymmetricTensor":
        rank, dim = flat.rank, flat.dim
        store = {}
        for k in _class_keys(rank, dim):
            if rank == 0:
                store[k] = flat.data.reshape(())
            else:
                store[k] = flat.data[flat.tables.class_positions(k)]
        return cls._raw(rank, dim, store)

    @classmethod
    def zeros(cls, rank: int, dim: int, dtype=None) -> "PermClsSymmetricTensor":
        return cls(rank=rank, dim=dim, dtype=dtype)

    # ----------------------------------------------------------- structure

    @property
    def size(self) -> int:
        """Independent components (reference permcls .size semantics,
        permcls_symtensor.py:877); stored element count can be smaller with
        scalar compression — see memory_footprint()."""
        return self.indep_size

    @property
    def dtype(self):
        return next(iter(self.data.values())).dtype

    def keys(self):
        """σ-class count-tuple keys of the per-class storage (reference
        permcls keys contract, base.py:854-869)."""
        return self.data.keys()

    def values(self):
        return iter(self.data.values())

    @property
    def scalar_classes(self) -> Tuple[str, ...]:
        """Labels of currently scalar-compressed classes."""
        return tuple(
            comb.class_label(k) for k, v in self.data.items() if v.ndim == 0
        )

    def astype(self, dtype) -> "PermClsSymmetricTensor":
        return self._raw(
            self.rank,
            self.dim,
            {k: v.astype(dtype) for k, v in self.data.items()},
        )

    def expand(self, cls=None) -> "PermClsSymmetricTensor":
        """Explicitly expand scalar-compressed classes to full vectors
        (static shape transition; do this before jit boundaries that need a
        fixed layout)."""
        targets = (
            [comb.as_class_counts(cls)] if cls is not None else list(self.data)
        )
        store = dict(self.data)
        for k in targets:
            v = store[k]
            if v.ndim == 0:
                s = comb.class_size(k, self.dim)
                store[k] = jnp.broadcast_to(v, (s,))
        return self._raw(self.rank, self.dim, store)

    def compress(self, cls=None, rtol: float = 0.0, atol: float = 0.0
                 ) -> "PermClsSymmetricTensor":
        """Explicitly scalar-compress classes whose values are all equal
        (within tolerance). Requires concrete (non-traced) data — this is a
        static shape transition, the inverse of expand()."""
        import numpy as np

        targets = (
            [comb.as_class_counts(cls)] if cls is not None else list(self.data)
        )
        store = dict(self.data)
        for k in targets:
            v = store[k]
            if v.ndim == 0:
                continue
            if isinstance(v, jax.core.Tracer):
                raise TypeError(
                    "compress() is a static shape transition and needs "
                    "concrete data (call outside jit)"
                )
            host = np.asarray(v)
            if host.size and np.allclose(host, host.flat[0], rtol=rtol,
                                         atol=atol):
                store[k] = jnp.asarray(host.flat[0], dtype=v.dtype)
        return self._raw(self.rank, self.dim, store)

    # ------------------------------------------------------------- content

    def toflat(self) -> FlatSymmetricTensor:
        if self.rank == 0:
            return FlatSymmetricTensor._raw(
                0, 1, next(iter(self.data.values())).reshape(1)
            )
        n = self.indep_size
        out = jnp.zeros((n,), dtype=self.dtype)
        t = self.tables
        for k, v in self.data.items():
            pos = t.class_positions(k)
            out = out.at[pos].set(jnp.broadcast_to(v, pos.shape))
        return FlatSymmetricTensor._raw(self.rank, self.dim, out)

    def todense(self) -> jnp.ndarray:
        return self.toflat().todense()

    def topermcls(self) -> "PermClsSymmetricTensor":
        return self

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> jnp.ndarray:
        counts = comb.as_class_counts(cls)
        if counts not in self.data:
            if sum(counts) != self.rank:
                raise ValueError(
                    f"σ-class {cls!r} has rank {sum(counts)}, tensor rank "
                    f"{self.rank}"
                )
            raise KeyError(
                f"σ-class {comb.class_label(counts)} is empty at dim {self.dim}"
            )
        return self.data[counts]

    def element(self, idx: Sequence[int]) -> jnp.ndarray:
        if self.rank == 0:
            return next(iter(self.data.values())).reshape(())
        idx = self._canon_index(idx)
        concrete = all(isinstance(i, (int, np.integer)) for i in idx)
        if not concrete:
            # Data-dependent class membership: go through the packed view.
            return self.toflat().element(idx)
        counts = comb.class_of_index(idx)
        leaf = self.data[counts]
        if leaf.ndim == 0:
            return leaf
        srt = tuple(sorted(int(i) for i in idx))
        gpos = self._gpos(srt)
        cpos = self.tables.class_positions_np(counts)
        local = int(np.searchsorted(cpos, gpos))
        assert cpos[local] == gpos
        return leaf[local]

    def _gpos(self, srt: Tuple[int, ...]) -> int:
        if any(i < 0 or i >= self.dim for i in srt):
            raise IndexError(f"index {srt} out of range for dim {self.dim}")
        if self.rank == 1:
            return srt[0]
        return self.tables.layout.position(srt)

    def _partial(self, idx: Tuple[int, ...]) -> "PermClsSymmetricTensor":
        return self.toflat()._partial(idx).topermcls()

    # ------------------------------------------------------------ updates

    def set_class(self, cls, value) -> "PermClsSymmetricTensor":
        counts = comb.as_class_counts(cls)
        if counts not in self.data:
            raise KeyError(
                f"σ-class {comb.class_label(counts)} invalid/empty for rank "
                f"{self.rank} dim {self.dim}"
            )
        v = jnp.asarray(value, dtype=self.dtype)
        s = comb.class_size(counts, self.dim)
        if v.ndim == 0:
            pass  # stays scalar-compressed
        elif v.shape != (s,):
            raise ValueError(
                f"class {comb.class_label(counts)} needs scalar or ({s},); "
                f"got {v.shape}"
            )
        store = dict(self.data)
        store[counts] = v
        return self._raw(self.rank, self.dim, store)

    def set_element(self, idx, value) -> "PermClsSymmetricTensor":
        if self.rank == 0:
            return self.set_class((), value)
        idx = self._canon_index(idx)
        concrete = all(isinstance(i, (int, np.integer)) for i in idx)
        if not concrete:
            return self.toflat().set_element(idx, value).topermcls()
        counts = comb.class_of_index(idx)
        leaf = self.data[counts]
        s = comb.class_size(counts, self.dim)
        if leaf.ndim == 0:
            # Write forces expansion (reference expands scalar storage on
            # elementwise write, permcls_symtensor.py:850-856).
            leaf = jnp.broadcast_to(leaf, (s,))
        srt = tuple(sorted(int(i) for i in idx))
        gpos = self._gpos(srt)
        cpos = self.tables.class_positions_np(counts)
        local = int(np.searchsorted(cpos, gpos))
        store = dict(self.data)
        store[counts] = leaf.at[local].set(
            jnp.asarray(value, dtype=self.dtype)
        )
        return self._raw(self.rank, self.dim, store)


def _class_keys(rank: int, dim: int) -> Tuple[comb.SigmaClass, ...]:
    """Non-empty σ-classes in canonical order."""
    return tuple(
        c for c in comb.perm_classes(rank) if comb.class_size(c, dim) > 0
    )
