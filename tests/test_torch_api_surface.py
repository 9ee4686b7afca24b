"""Every public method of ``otters_tpu``'s user-facing classes exists on the
port's class of the same name.

The port has ported every method; the cases that held stubs now hold each
ported method's signature equal to JAX's and call it
(``parallel.init_distributed``'s call runs in ``test_torch_multihost.py``'s
workers).
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu.parallel as jpar
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
import otters_tpu_torch.parallel as tpar

CLASSES = ["MetaStoreBuilder", "MetaStore", "MetaQueryPlan", "MetaQueryResults", "VecStore",
           "VecQueryPlan", "ShardedMetaStore", "ShardedVecStore"]


def _cls(pkg, mod, name):
    par = jpar if pkg is jx else tpar
    return getattr(pkg, name, None) or getattr(mod, name, None) or getattr(par, name)


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
# test_torch_mutation.py, save / load in test_torch_io.py. The three cases
# below held stubs; each now holds the method's signature equal to JAX's and
# calls it.
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
    args = {"build_sharded": (tpar.make_mesh(rows=2, devices=["cpu"] * 2),)}.get(method, ())
    out = getattr(obj, method)(*args)
    if method == "build_sharded":
        assert isinstance(out, tpar.ShardedMetaStore) and len(out) == n
    elif method == "to_pandas":
        assert list(out["index"]) == obj.indices and list(out.columns) == ["index", "score", "id"]
    else:
        assert out.num_rows == 3 and out.column_names == ["index", "score", "id"]


def test_init_distributed_raises_with_jax_signature():
    """The port takes JAX's three parameters first, with JAX's defaults
    (then its keyword-only ``local_devices``). No process group is made in
    the pytest worker: the call itself, and the second call that raises,
    run in the workers of ``test_torch_multihost.py``."""
    jsig = inspect.signature(jpar.init_distributed)
    tsig = inspect.signature(tpar.init_distributed)
    jparams = [(p.name, p.default) for p in jsig.parameters.values()]
    tparams = list(tsig.parameters.values())
    assert [(p.name, p.default) for p in tparams[: len(jparams)]] == jparams
    assert [(p.name, p.kind, p.default) for p in tparams[len(jparams):]] == \
        [("local_devices", inspect.Parameter.KEYWORD_ONLY, None)]
    assert tpar.process_index() == 0 and tpar.process_count() == 1


def test_submodules_import_without_jax_or_dataframes():
    """``parallel``, ``adapters`` and ``datasets`` import neither JAX nor
    the JAX package; ``import otters_tpu_torch`` needs neither pandas nor
    pyarrow (the adapters import them inside their functions)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(tx.__file__)))
    code = (
        "import sys, otters_tpu_torch.parallel, otters_tpu_torch.adapters, "
        "otters_tpu_torch.datasets, otters_tpu_torch.evaluate\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'otters_tpu', 'pandas', 'pyarrow')]\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
