"""Every public method of ``otters_tpu``'s user-facing classes exists on the
port's class of the same name.

A method the port has not ported yet exists all the same and raises
``NotImplementedError`` (with the JAX package's signature), so a caller
learns what is missing rather than meeting an ``AttributeError``.
"""

import inspect

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta

CLASSES = ["MetaStoreBuilder", "MetaStore", "MetaQueryPlan", "MetaQueryResults", "VecStore",
           "VecQueryPlan"]


def _cls(pkg, mod, name):
    return getattr(pkg, name, None) or getattr(mod, name)


def _public(cls):
    return sorted(n for n, v in vars(cls).items()
                  if not n.startswith("_") and callable(getattr(cls, n)))


@pytest.mark.parametrize("name", CLASSES)
def test_every_public_method_exists_on_the_port(name):
    jcls, tcls = _cls(jx, jmeta, name), _cls(tx, tmeta, name)
    missing = [m for m in _public(jcls) if not callable(getattr(tcls, m, None))]
    assert missing == [], f"{name} lacks {missing}"


# the ported methods' signatures are held in their own files:
# with_sort_by / with_z_order in test_torch_sort.py, delete_rows / append in
# test_torch_mutation.py, save / load in test_torch_io.py
STUBS = {
    "MetaStoreBuilder": ["build_sharded"],
    "MetaQueryResults": ["to_pandas", "to_arrow"],
}


@pytest.mark.parametrize("name,method", [(c, m) for c, ms in STUBS.items() for m in ms])
def test_unported_methods_raise_not_implemented_with_jax_signatures(name, method):
    jcls, tcls = _cls(jx, jmeta, name), _cls(tx, tmeta, name)
    jsig = inspect.signature(getattr(jcls, method))
    tsig = inspect.signature(getattr(tcls, method))
    assert list(tsig.parameters) == list(jsig.parameters)
    n = 600
    cols = [tx.Column("id", tx.DataType.Int64).from_values(np.arange(n))]
    builder = tx.MetaStore.from_columns(cols).with_vectors(
        np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)).with_device("cpu")
    obj = builder
    if name != "MetaStoreBuilder":
        obj = builder.build()
    if name == "MetaQueryResults":
        obj = obj.query(np.ones(8, np.float32), tx.Metric.Cosine).take(3).collect()
    args = {"build_sharded": (None,)}.get(method, ())
    with pytest.raises(NotImplementedError):
        getattr(obj, method)(*args)
