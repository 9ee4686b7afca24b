"""The traffic kind ``closed_loop``: one client, rounds of ``depth`` requests.

The mix's data file sets it. The client sends ``depth`` requests of
``batch`` queries each, each with ``collect_async``, then finishes them
together (``finish``: ``resolve`` or each one's ``result()``) and sends the
next ``depth``. The queries cycle through the pool that the inputs drew
from the seed. A request's latency runs from the call that sends it to the
return of the call that finishes it. The window closes at the end of the
first round that ends after ``seconds``: no request is dropped.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional

from benchmark.window import Request, Window


def _round(api, pool_queries, depth: int, first: int, span: Callable) -> List[Request]:
    n_pool = pool_queries.shape[0]
    pend, sent, took = [], [], []
    for j in range(depth):
        q = pool_queries[(first + j) % n_pool]
        t0 = time.perf_counter()
        with span("bench.submit"):
            pend.append(api.submit(q))
        t1 = time.perf_counter()
        sent.append(t0)
        took.append(t1 - t0)
    with span("bench.finish"):
        results = api.finish(pend)
    done = time.perf_counter()
    out = []
    with span("bench.stats"):
        for j, (p, res) in enumerate(zip(pend, results)):
            st = p.stats()
            out.append(Request(
                pool=(first + j) % n_pool, sent_at=sent[j], submit_s=took[j],
                latency_s=done - sent[j],
                indices=list(res.indices), scores=list(res.scores),
                total_chunks=st.total_chunks, evaluated_chunks=st.evaluated_chunks,
                merge_s=st.merge_duration, certified=st.certified,
            ))
    return out


def warm(api, pool_queries, mix: dict):
    """Compile the mix's shapes and run one round outside the window, on the
    pool's first entries. -> (programs compiled, the round's requests)."""
    depth = int(mix["depth"])
    n_programs = api.precompile(int(pool_queries.shape[1]), depth)
    return n_programs, _round(api, pool_queries, depth, 0, lambda _name: contextlib.nullcontext())


def run(api, pool_queries, mix: dict, seconds: float,
        span: Optional[Callable] = None) -> Window:
    """Closed-loop rounds for ``seconds``; ``span(name)`` wraps each call
    into the program (a profiler's ``record_function`` in a traced run)."""
    span = span or (lambda _name: contextlib.nullcontext())
    depth = int(mix["depth"])
    batch = int(pool_queries.shape[1])
    window = Window(requests=[], queries=0, seconds=0.0)
    with window.gc:
        t_start = window.started = time.perf_counter()
        while True:
            window.requests += _round(api, pool_queries, depth, len(window.requests), span)
            if time.perf_counter() - t_start >= seconds:
                break
        window.seconds = time.perf_counter() - t_start
    window.queries = len(window.requests) * batch
    return window
