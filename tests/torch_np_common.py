"""Shared piece of the ``mx.np`` / ``mx.npx`` / ``ndarray`` parity tests
(``tests/test_torch_{numpy,npx,ndarray}.py``): the JAX package's side of
many cases computed once, with one XLA compile.

Run eagerly, the JAX package compiles every op at its first call at each
shape (tens of ms each on the CPU), so the JAX side would take most of
these tests' time.  `jax_results` traces each case's JAX function once
(its ops, and its ``autograd.record()`` / ``backward()`` where it has
them, as a hybridized block traces them); the cases that trace are
evaluated together in one ``jax.jit`` with their inputs passed as
arguments, so XLA folds no constant and compiles once.  The others (a
host read, a data-dependent shape, a Python value out) run eagerly.
"""
import jax

from mxnet_tpu.ndarray.ndarray import from_jax, ndarray


def _leaves(out, tags):
    """The jax arrays of `out` (an ndarray, or tuples / lists of them),
    with its nesting appended to `tags`; anything else raises TypeError."""
    if isinstance(out, ndarray):
        tags.append("a")
        return [out._data]
    if isinstance(out, (tuple, list)):
        tags.append((type(out), len(out)))
        return [v for o in out for v in _leaves(o, tags)]
    raise TypeError(f"not an array: {type(out).__name__}")


def _rebuild(tags, arrays):
    tag = tags.pop(0)
    if tag == "a":
        return from_jax(arrays.pop(0))
    kind, n = tag
    return kind(_rebuild(tags, arrays) for _ in range(n))


def jax_results(fns):
    """`{key: fn()}` for `fns`, a dict of the JAX package's case functions
    (no arguments); a case whose function raises maps to the exception."""
    out, traced = {}, {}
    for key, fn in fns.items():
        tags = []
        try:
            closed = jax.make_jaxpr(lambda: _leaves(fn(), tags))()
        except Exception:                       # host reads, non-arrays
            try:
                out[key] = fn()
            except Exception as e:              # noqa: BLE001
                out[key] = e
            continue
        traced[key] = (closed, tags)

    cases = list(traced.values())

    def run(consts):
        return [jax.core.eval_jaxpr(c.jaxpr, k)
                for (c, _), k in zip(cases, consts)]

    arrays = jax.jit(run)([c.consts for c, _ in cases])
    for key, (_, tags), arr in zip(traced, cases, arrays):
        out[key] = _rebuild(list(tags), list(arr))
    return out


def want(results, key):
    """`results[key]`, raising the exception a case raised."""
    got = results[key]
    if isinstance(got, Exception):
        raise got
    return got
