"""The port's load and demand sums are exact, so they do not depend on the
order of the adds (ROADMAP queue 3, item 19).

Degrees are integers, so a bin sum of them is an integer; but an f32 running
sum is exact only while every partial sum stays below 2^24 = 16,777,216.
Past that line each add rounds, and the result depends on the order of the
adds, which CUDA's atomic `index_add_` does not fix: two card runs with one
seed could then give different loads, migration gates and labels. Table I's
LJ at k = 4, HLWD at k = 8 and EU cross it. The port sums in int64 and
rounds to f32 once (`metrics.bin_sums`, `metrics.moved_sums`).

Where the port now differs from `repro`: `repro` sums the same values in
f32 with ``.at[].add`` in a fixed (vertex) order, so above 2^24 it keeps
that order's rounding, while the port gives the exact sum rounded once. On
this file's synthetic input (60,001 vertices with odd degrees 1-1999, 90 %
of the degree mass, 53,962,173, in part 0) `repro`'s part-0 load is
53,962,008 and the port's 53,962,172: 164 apart, 3.0e-6 relative; the
other three parts (each below 2^24) are equal. Below 2^24 both are exact
and equal bit for bit (`test_below_two_to_the_24_the_sums_equal_repros`,
and the step-for-step parity tests of `test_torch_rules.py`,
`test_torch_superstep.py` and `test_torch_core.py`).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch.core import engine, metrics

K = 4


def _inputs(n: int, max_half_degree: int, seed: int = 19):
    """Odd degrees in [1, 2 * max_half_degree), labels sending ~90 % of the
    vertices (and of the degree mass) to part 0."""
    rng = np.random.default_rng(seed)
    deg = (rng.integers(0, max_half_degree, n) * 2 + 1).astype(np.float32)
    labels = np.where(rng.random(n) < 0.9, 0, rng.integers(1, K, n)).astype(np.int32)
    other = rng.integers(0, K, n).astype(np.int32)
    return deg, labels, other, rng.permutation(n)


SUMS = {
    "loads_from_labels": lambda lab, deg, other: engine.loads_from_labels(
        types.SimpleNamespace(deg_out=deg), K, lab),
    "partition_loads": lambda lab, deg, other: metrics.partition_loads(lab, deg, K),
    # the rules' demand m(l): the degree of every vertex that wants to move
    "demand": lambda lab, deg, other: metrics.bin_sums(lab, deg * (lab != other), K),
    # the rules' load delta: the migrating degree moves from one part to another
    "load_delta": lambda lab, deg, other: metrics.moved_sums(other, lab, deg, K),
}


def _run(name, deg, labels, other, order):
    t = [torch.from_numpy(np.ascontiguousarray(a[order])) for a in (labels, deg, other)]
    return SUMS[name](t[0], t[1], t[2])


@pytest.mark.parametrize("name", sorted(SUMS))
def test_sums_past_two_to_the_24_do_not_depend_on_the_vertex_order(name):
    deg, labels, other, perm = _inputs(60_001, 1000)
    mass = np.bincount(labels, weights=deg.astype(np.float64), minlength=K)
    assert mass[0] > 3 * 2 ** 24                 # the fault's regime
    first = _run(name, deg, labels, other, np.arange(len(deg)))
    again = _run(name, deg, labels, other, perm)
    assert first.dtype == torch.float32
    assert torch.equal(first, again), (first, again)


@pytest.mark.parametrize("name", sorted(SUMS))
def test_sums_are_the_exact_sum_rounded_once(name):
    deg, labels, other, _ = _inputs(60_001, 1000)
    got = _run(name, deg, labels, other, np.arange(len(deg)))
    d = deg.astype(np.float64)
    if name == "load_delta":
        exact = (np.bincount(labels, weights=d, minlength=K)
                 - np.bincount(other, weights=d, minlength=K))
    elif name == "demand":
        exact = np.bincount(labels, weights=d * (labels != other), minlength=K)
    else:
        exact = np.bincount(labels, weights=d, minlength=K)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def test_below_two_to_the_24_the_sums_equal_repros():
    """Every bin and partial sum below 2^24: the port and `repro`'s fixed-order
    f32 ``.at[].add`` are both exact, so equal bit for bit."""
    deg, labels, other, _ = _inputs(20_001, 200)
    assert np.bincount(labels, weights=deg.astype(np.float64)).max() < 2 ** 24
    t_lab, t_deg, t_oth = (torch.from_numpy(a) for a in (labels, deg, other))
    want = jnp.zeros((K,), jnp.float32).at[labels].add(deg)
    np.testing.assert_array_equal(metrics.partition_loads(t_lab, t_deg, K).numpy(),
                                  np.asarray(want))
    j_loads = want.at[other].add(-deg).at[labels].add(deg)
    t_loads = torch.from_numpy(np.array(want)) + metrics.moved_sums(t_oth, t_lab, t_deg, K)
    np.testing.assert_array_equal(t_loads.numpy(), np.asarray(j_loads))


def test_past_two_to_the_24_the_port_differs_from_repros_f32_order_as_logged():
    """The logged difference (module docstring): `repro`'s fixed-order f32
    sum of part 0 is 164 below the port's exact sum rounded once."""
    deg, labels, _, _ = _inputs(60_001, 1000)
    want = np.asarray(jnp.zeros((K,), jnp.float32).at[labels].add(deg))
    got = metrics.partition_loads(torch.from_numpy(labels), torch.from_numpy(deg), K).numpy()
    assert got[0] == 53_962_172.0 and want[0] == 53_962_008.0
    np.testing.assert_array_equal(got[1:], want[1:])
