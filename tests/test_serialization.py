"""Serialization round-trips (reference testing/api.py:412-424 analog) +
pytree checkpointability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu import serialization as ser
from symtensor_tpu.ops.symmetrize import symmetrize


def random_sym(rank, dim, rng):
    return np.asarray(symmetrize(rng.normal(size=(dim,) * rank)))


@pytest.mark.parametrize(
    "fmt", [st.DenseSymmetricTensor, st.FlatSymmetricTensor, st.PermClsSymmetricTensor]
)
def test_json_roundtrip(fmt, rng):
    A = fmt.from_dense(random_sym(3, 4, rng))
    B = ser.from_json(ser.to_json(A))
    assert type(B) is type(A)
    assert (B.rank, B.dim) == (A.rank, A.dim)
    assert A.allclose(B, rtol=1e-12, atol=1e-12)


def test_json_roundtrip_decomp(rng):
    A = st.DecompSymmetricTensor(
        rank=3,
        dim=4,
        weights=jnp.asarray(rng.normal(size=(2, 2))),
        factors=jnp.asarray(rng.normal(size=(2, 4))),
        multiplicities=(2, 1),
    )
    B = ser.from_json(ser.to_json(A))
    assert B.multiplicities == (2, 1)
    assert A.toflat().allclose(B.toflat())


def test_json_scalar_compression_preserved(rng):
    A = st.PermClsSymmetricTensor(rank=3, dim=6, data={"iii": 2.0})
    B = ser.from_json(ser.to_json(A))
    assert set(B.scalar_classes) == set(A.scalar_classes)
    assert A.allclose(B)


@pytest.mark.parametrize(
    "fmt", [st.FlatSymmetricTensor, st.PermClsSymmetricTensor]
)
def test_npz_roundtrip(fmt, tmp_path, rng):
    A = fmt.from_dense(random_sym(4, 3, rng))
    p = str(tmp_path / "t.npz")
    ser.save(p, A)
    B = ser.load(p)
    assert type(B) is type(A)
    assert A.array_equal(B)


def test_npz_roundtrip_decomp(tmp_path, rng):
    A = st.DecompSymmetricTensor.from_vector(jnp.asarray(rng.normal(size=5)), 3)
    p = str(tmp_path / "d.npz")
    ser.save(p, A)
    B = ser.load(p)
    assert B.multiplicities == A.multiplicities
    assert A.toflat().array_equal(B.toflat())


def test_pytree_checkpoint_shape(rng):
    """Any tensor is a pytree of arrays — flatten/unflatten round-trips, so
    orbax-style checkpointing works out of the box."""
    A = st.PermClsSymmetricTensor.from_dense(random_sym(3, 4, rng))
    leaves, treedef = jax.tree.flatten(A)
    as_np = [np.asarray(l) for l in leaves]  # what a checkpointer stores
    B = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in as_np])
    assert A.array_equal(B)


def test_npz_path_without_suffix(tmp_path, rng):
    A = st.FlatSymmetricTensor.from_dense(random_sym(2, 3, rng))
    p = str(tmp_path / "noext")
    ser.save(p, A)
    B = ser.load(p)
    assert A.array_equal(B)


# ---------------------------------------------------------------------------
# Reference (scityping) payload import
# ---------------------------------------------------------------------------


def _reference_payload(dense, rank, dim):
    """Build a payload in the reference's documented encode shape
    (permcls_symtensor.py:686-708): (rank, dim, {str(σ-counts): values}),
    per-class values in σindex_iter order."""
    from symtensor_tpu.serialization import _reference_class_indices
    from symtensor_tpu.utils import combinatorics as comb

    data = {}
    for counts in comb.perm_classes(rank):
        idx = list(_reference_class_indices(counts, dim))
        if not idx:
            continue
        vals = [float(dense[i]) for i in idx]
        data[str(tuple(counts))] = vals
    return [rank, dim, data]


@pytest.mark.parametrize("rank,dim", [(0, 1), (1, 4), (2, 3), (3, 4), (4, 3)])
def test_from_reference_json(rank, dim, rng):
    import json

    dense = random_sym(rank, dim, rng)
    payload = _reference_payload(dense, rank, dim)
    # raw encode list, dict form, scityping [type, payload] wrapper, and
    # the JSON string of each must all decode identically
    forms = [
        payload,
        {"rank": rank, "dim": dim, "data": payload[2]},
        ["symtensor.permcls_symtensor.PermClsSymmetricTensor.Data",
         {"rank": rank, "dim": dim, "data": payload[2]}],
    ]
    for form in forms + [json.dumps(f) for f in forms]:
        t = ser.from_reference_json(form)
        assert isinstance(t, st.PermClsSymmetricTensor)
        np.testing.assert_allclose(
            np.asarray(t.todense()), dense, atol=1e-12
        )


def test_from_reference_json_partial_and_errors(rng):
    # partial class dict: missing classes are zero (reference
    # permcls_symtensor.py:661 allows subsets)
    dense = random_sym(3, 3, rng)
    payload = _reference_payload(dense, 3, 3)
    data = dict(payload[2])
    removed = data.pop(str((1, 1, 1)))
    t = ser.from_reference_json([3, 3, data])
    got = np.asarray(t.class_values("ijk"))
    np.testing.assert_allclose(got, 0.0)
    np.testing.assert_allclose(
        np.asarray(t.class_values("iij")),
        np.asarray(
            ser.from_reference_json(payload).class_values("iij")
        ),
    )
    # wrong-rank key and wrong-length values raise
    with pytest.raises(ValueError):
        ser.from_reference_json([3, 3, {"(2, 2)": [1.0]}])
    with pytest.raises(ValueError):
        ser.from_reference_json([3, 3, {"(3,)": [1.0]}])
    with pytest.raises(ValueError):
        ser.from_reference_json({"rank": 3, "dim": 3})


@pytest.mark.parametrize("rank,dim", [(0, 1), (1, 4), (2, 3), (3, 4), (4, 3)])
def test_to_reference_json_roundtrip(rank, dim, rng):
    """Import a reference-layout payload, export it, and get the exact
    same dict back (two-way serialization interop)."""
    import json

    dense = random_sym(rank, dim, rng)
    payload = _reference_payload(dense, rank, dim)
    t = ser.from_reference_json(payload)
    got_rank, got_dim, got = ser.to_reference_payload(t)
    assert (got_rank, got_dim) == (rank, dim)
    want = payload[2]
    # exporter emits EVERY class of the rank (reference items()); classes
    # the builder skipped (empty at this dim) must come back empty
    for key, vals in got.items():
        if key in want:
            np.testing.assert_allclose(
                np.asarray(vals, dtype=float), want[key], atol=1e-12
            )
        else:
            assert np.asarray(vals).size == 0
    assert set(want) <= set(got)
    # JSON form round-trips byte-for-byte through the importer
    s = ser.to_reference_json(t)
    t2 = ser.from_reference_json(s)
    assert ser.to_reference_json(t2) == s
    decoded = json.loads(s)
    assert decoded[0] == rank and decoded[1] == dim


def test_from_reference_json_complex_and_canonical_keys(rng):
    # complex payload survives (ADVICE r4: float64 staging discarded the
    # imaginary part)
    dense = random_sym(2, 3, rng) + 1j * random_sym(2, 3, rng)
    payload = _reference_payload_complex(dense, 2, 3)
    t = ser.from_reference_json(payload)
    assert np.iscomplexobj(np.asarray(t.toflat().data))
    got = np.asarray(t.todense())
    np.testing.assert_allclose(got, dense.astype(got.dtype), atol=1e-5)
    # non-canonical (ascending) σ-class key raises instead of silently
    # permuting values (ADVICE r4)
    with pytest.raises(ValueError, match="canonical"):
        ser.from_reference_json([3, 3, {"(1, 2)": [1.0, 2.0, 3.0]}])


def _reference_payload_complex(dense, rank, dim):
    from symtensor_tpu.serialization import _reference_class_indices
    from symtensor_tpu.utils import combinatorics as comb

    data = {}
    for counts in comb.perm_classes(rank):
        idx = list(_reference_class_indices(counts, dim))
        if not idx:
            continue
        data[str(tuple(counts))] = [
            [complex(dense[i]).real, complex(dense[i]).imag] for i in idx
        ]
    # scityping-style complex arrays arrive as {"data": ..., "dtype": ...}
    return [
        rank,
        dim,
        {
            k: {"data": [complex(a, b) for a, b in v], "dtype": "complex128"}
            for k, v in data.items()
        },
    ]


def test_reference_class_order_contract():
    """The documented σindex_iter examples (permcls_symtensor.py:272-279)."""
    from symtensor_tpu.serialization import _reference_class_indices

    assert list(_reference_class_indices((2, 1), 3)) == [
        (0, 0, 1), (0, 0, 2), (1, 1, 0), (1, 1, 2), (2, 2, 0), (2, 2, 1)
    ]
    assert list(_reference_class_indices((2, 2), 3)) == [
        (0, 0, 1, 1), (0, 0, 2, 2), (1, 1, 2, 2)
    ]


def test_pydantic_model_embedding(rng):
    """A SymmetricTensor as a pydantic-model field round-trips through
    model JSON (reference testing/api.py:420-424)."""
    pydantic = pytest.importorskip("pydantic")

    class Foo(pydantic.BaseModel):
        model_config = dict(arbitrary_types_allowed=True)
        A: st.SymmetricTensor

    for fmt in (st.FlatSymmetricTensor, st.PermClsSymmetricTensor):
        A = fmt.from_dense(random_sym(3, 3, rng))
        foo = Foo(A=A)
        foo2 = Foo.model_validate_json(foo.model_dump_json())
        assert isinstance(foo2.A, st.SymmetricTensor)
        assert foo2.A.format == A.format
        assert A.array_equal(foo2.A)
        assert foo2.model_dump_json() == foo.model_dump_json()
