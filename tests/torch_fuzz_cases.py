"""The differential fuzz's random stores, filters and numpy oracle, shared by
``tests/test_torch_differential_fuzz.py``: the draws of the JAX package's
``tests/test_differential_fuzz.py`` in its order (so its seeds give its
trials), each column and filter built in either package from the same
draws, and an oracle that reads either package's compiled filter.

The oracle is an independent reimplementation of the reference semantics
(exact scoring, CNF row filtering with null exclusion, a global merged
top-k) in numpy.
"""

import datetime

import numpy as np

DTYPES = ["Int32", "Int64", "Float32", "Float64", "String", "DateTime", "Bool"]
METRICS = ["Cosine", "DotProduct", "Euclidean", "Manhattan", "Hamming", "Jaccard"]


def lev(a: str, b: str) -> int:
    """Levenshtein distance, the full table (no band)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[lb]


def random_raw(dt: str, n: int, rng) -> list:
    """A column's values (None for nulls) of DataType name ``dt``."""
    null_p = rng.uniform(0, 0.3)
    nulls = rng.uniform(size=n) < null_p
    if dt == "Int32":
        vals = rng.integers(-50, 50, n)
    elif dt == "Int64":
        vals = rng.integers(-(2**40), 2**40, n)
    elif dt == "Float32":
        vals = rng.normal(0, 10, n).astype(np.float32)
    elif dt == "Float64":
        vals = rng.normal(0, 10, n)
    elif dt == "String":
        vals = rng.choice([f"s{i}" for i in range(8)], n)
    elif dt == "Bool":
        vals = rng.uniform(size=n) < 0.5
    else:  # DateTime: days in 2024
        vals = rng.integers(0, 300, n)
    raw = []
    for i in range(n):
        if nulls[i]:
            raw.append(None)
        elif dt == "String":
            raw.append(str(vals[i]))
        elif dt == "Bool":
            raw.append(bool(vals[i]))
        elif dt == "DateTime":
            raw.append(1704067200000 + int(vals[i]) * 86400_000)  # 2024-01-01 + d
        elif dt in ("Float32", "Float64"):
            raw.append(float(vals[i]))
        else:
            raw.append(int(vals[i]))
    return raw


def random_columns(n: int, rng):
    """(schema {name: DataType name}, raws {name: values}) of 1-3 columns."""
    schema, raws = {}, {}
    for ci in range(int(rng.integers(1, 4))):
        dt = DTYPES[rng.integers(0, len(DTYPES))]
        schema[f"c{ci}"] = dt
        raws[f"c{ci}"] = random_raw(dt, n, rng)
    return schema, raws


def columns(pkg, schema, raws):
    return [pkg.Column(name, getattr(pkg.DataType, dt)).from_values(raws[name])
            for name, dt in schema.items()]


def random_leaf(name: str, dt: str, raw, rng):
    """Draw one leaf -> a recipe ``pkg -> Expr`` (the draws happen now)."""
    non_null = [v for v in raw if v is not None]
    if rng.random() < 0.12:
        op, args = ("is_null", ()) if rng.random() < 0.5 else ("is_not_null", ())
    elif dt == "Bool":
        target = bool(rng.random() < 0.5)
        op, args = ("eq" if rng.random() < 0.5 else "neq"), (target,)
    elif dt == "String":
        target = str(rng.choice(non_null)) if non_null else "s0"
        choice = rng.random()
        if choice < 0.3:
            op, args = "eq", (target,)
        elif choice < 0.5:
            op, args = "neq", (target,)
        elif choice < 0.65:
            op, args = "contains", (target[: max(1, len(target) - 1)],)
        elif choice < 0.75:
            op, args = "starts_with", (target[:1],)
        elif choice < 0.85:
            op, args = "ends_with", (target[-1:],)
        else:
            op, args = "fuzzy", (target, int(rng.integers(0, 3)))
    else:
        op = str(rng.choice(["eq", "neq", "lt", "lte", "gt", "gte"]))
        if dt == "DateTime":
            ms = int(rng.choice(non_null)) if non_null else 1704067200000
            s = datetime.datetime.fromtimestamp(
                ms / 1000, tz=datetime.timezone.utc
            ).strftime("%Y-%m-%dT%H:%M:%SZ")
            args = (s,)
        elif dt in ("Int32", "Int64"):
            choice = rng.random()
            if choice < 0.12 and len(non_null) >= 2:
                op, args = "isin", ([int(v) for v in rng.choice(non_null, size=3)],)
            elif choice < 0.24 and len(non_null) >= 2:
                lo, hi = sorted((int(rng.choice(non_null)), int(rng.choice(non_null))))
                op, args = "between", (lo, hi)
            else:
                args = (int(rng.choice(non_null)) if non_null else 0,)
        else:
            args = (float(rng.choice(non_null)) if non_null else 0.0,)
    # random negation exercises the De Morgan push-down on every leaf kind
    negate = rng.random() < 0.25

    def build(pkg):
        leaf = getattr(pkg.col(name), op)(*args)
        return ~leaf if negate else leaf

    return build


def random_expr(schema, raws, rng):
    """A CNF expression over 1-3 random leaves -> a recipe ``pkg -> Expr``."""
    leaves = [random_leaf(name, schema[name], raws[name], rng)
              for name in rng.choice(list(schema), size=rng.integers(1, 4))]
    ands = [rng.random() < 0.5 for _ in leaves[1:]]

    def build(pkg):
        expr = leaves[0](pkg)
        for leaf, use_and in zip(leaves[1:], ands):
            expr = (expr & leaf(pkg)) if use_and else (expr | leaf(pkg))
        return expr

    return build


def _oracle_str(v: str, cmp: str, rhs) -> bool:
    if cmp.startswith("Not") and cmp != "NotNull":
        return not _oracle_str(v, cmp[3:], rhs)
    if cmp == "Eq":
        return v == rhs
    if cmp == "Neq":
        return v != rhs
    if cmp == "Contains":
        return rhs in v
    if cmp == "StartsWith":
        return v.startswith(rhs)
    if cmp == "EndsWith":
        return v.endswith(rhs)
    if cmp == "Fuzzy":
        pattern, max_dist = rhs
        return lev(v, pattern) <= max_dist
    raise AssertionError(cmp)


def _oracle_leaf_mask(dt: str, raw, cmp: str, rhs) -> np.ndarray:
    out = np.zeros(len(raw), dtype=bool)
    for i, v in enumerate(raw):
        if cmp == "IsNull":
            out[i] = v is None
        elif cmp == "IsNotNull":
            out[i] = v is not None
        elif v is None:
            continue
        elif dt == "String":
            out[i] = _oracle_str(v, cmp, rhs)
        else:
            out[i] = {"Eq": v == rhs, "Neq": v != rhs, "Lt": v < rhs, "Lte": v <= rhs,
                      "Gt": v > rhs, "Gte": v >= rhs}[cmp]
    return out


def oracle(vectors, queries, metric: str, compiled, raws, schema, k, thr, cmp,
           alive=None):
    """(the top-k scores in take order, the row mask) of a query:
    ``compiled`` is either package's compiled filter (its leaves' ``cmp``
    read by name), ``cmp`` the name of the vec_filter's comparison."""
    n = len(vectors)
    mask = np.ones(n, dtype=bool)
    if alive is not None:
        mask &= alive
    for clause in compiled.clauses:
        cm = np.zeros(n, dtype=bool)
        for lf in clause:
            cm |= _oracle_leaf_mask(schema[lf.column], raws[lf.column], lf.cmp.name, lf.rhs)
        mask &= cm
    take_min = metric in ("Euclidean", "Manhattan", "Hamming")
    if metric == "DotProduct":
        s = queries @ vectors.T
    elif metric == "Cosine":
        qi = np.linalg.norm(queries, axis=1)
        qi = np.where(qi != 0, 1.0 / qi, 0.0)
        vi = np.linalg.norm(vectors, axis=1)
        vi = np.where(vi != 0, 1.0 / vi, 0.0)
        s = (queries @ vectors.T) * qi[:, None] * vi[None, :]
    elif metric == "Manhattan":
        s = np.abs(queries[:, None, :] - vectors[None, :, :]).sum(axis=2)
    elif metric == "Hamming":
        s = (queries[:, None, :] != vectors[None, :, :]).sum(axis=2).astype(np.float64)
    elif metric == "Jaccard":
        num = np.minimum(queries[:, None, :], vectors[None, :, :]).sum(axis=2)
        den = np.maximum(queries[:, None, :], vectors[None, :, :]).sum(axis=2)
        s = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    else:
        s = (queries**2).sum(1)[:, None] + (vectors**2).sum(1)[None, :] - 2 * queries @ vectors.T
    ok = np.broadcast_to(mask[None, :], s.shape).copy()
    if thr is not None:
        ok &= {"Gt": s > thr, "Lt": s < thr, "Gte": s >= thr, "Lte": s <= thr}[cmp]
    order = np.sort(s[ok])
    return (order[:k] if take_min else order[::-1][:k]), mask
