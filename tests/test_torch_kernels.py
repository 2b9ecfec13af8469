"""The port's kernel modules on the CPU: plain versions against `repro`'s
oracles and Pallas kernels (interpret mode), the device routing, and the
launch counters. The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.edge_phase import fused_edge_phase_pallas
from repro.kernels.la_update import la_update_pallas

from repro_torch.core.device_graph import SpanPlan
from repro_torch.graphs.blocking import slab_row_ptr
from repro_torch.kernels import edge_phase, la_update, ops

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def row_sorted_slab(rng, nb, e_max, block_v, k):
    """Random slabs with the `block_edges` layout: a live, row-sorted prefix
    of eq.-(4) weights in {1, 2}, then zero-weight padding (dst = row = 0)."""
    n_pad = nb * block_v
    dst = np.zeros((nb, e_max), np.int32)
    rows = np.zeros((nb, e_max), np.int32)
    vals = np.zeros((nb, e_max), np.float32)
    for b in range(nb):
        cnt = int(rng.integers(e_max // 2, e_max + 1))
        rows[b, :cnt] = np.sort(rng.integers(0, block_v, cnt))
        dst[b, :cnt] = rng.integers(0, n_pad, cnt)
        vals[b, :cnt] = rng.integers(1, 3, cnt)
    labels = rng.integers(0, k, n_pad).astype(np.int32)
    lam = rng.integers(0, k, n_pad).astype(np.int32)
    actions = rng.integers(0, k, (nb, block_v)).astype(np.int32)
    feasible = (rng.random((nb, k)) > 0.3).astype(np.float32)
    return dst, rows, vals, labels, lam, actions, feasible


def walk_rows(dst, vals, row_ptr, labels, lam, actions, feasible, *, block_v,
              k, weight_mode):
    """A row walk in numpy: each row sums its run ``[row_ptr[r],
    row_ptr[r+1])`` of the slab in order (the span design of the CUDA kernel
    is emulated in tests/test_torch_kernel_designs.py)."""
    nb = dst.shape[0]
    hist = np.zeros((nb, block_v, k), np.float32)
    wacc = np.zeros((nb, block_v, k), np.float32)
    for b in range(nb):
        for r in range(block_v):
            for e in range(row_ptr[b, r], row_ptr[b, r + 1]):
                w = vals[b, e]
                if not w > 0:
                    continue
                u = dst[b, e]
                hist[b, r, labels[u]] += w
                agree = actions[b, r] == lam[u]
                if weight_mode == "neighbor_lambda":
                    wacc[b, r, lam[u]] += w if agree else feasible[b, lam[u]]
                elif agree:
                    wacc[b, r, 0] += w
                else:
                    wacc[b, r, 1] += 1.0
    return hist, wacc


# the sweep of tests/test_kernels.py:50, plus k = 3 and k = 5 at nb in {1, 3}
EDGE_SHAPES = [
    (1, 256, 64, 8, 256),
    (3, 512, 128, 10, 256),
    (2, 1024, 256, 32, 512),
    (2, 768, 32, 5, 256),
    (1, 256, 64, 3, 256),
    (3, 512, 128, 5, 256),
]


@pytest.mark.parametrize("weight_mode", ["self_lambda", "neighbor_lambda"])
@pytest.mark.parametrize("nb,e_max,block_v,k,chunk", EDGE_SHAPES)
def test_fused_edge_phase_plain_exact(nb, e_max, block_v, k, chunk, weight_mode):
    """Bit-exact against the numpy oracle, the interpret-mode Pallas kernel
    and the row-walk the CUDA kernel performs: the weights are integers in
    {1, 2}, so every sum is exact in any order."""
    rng = np.random.default_rng(nb * 1000 + k)
    inputs = row_sorted_slab(rng, nb, e_max, block_v, k)
    dst, rows, vals, labels, lam, actions, feasible = inputs
    row_ptr = slab_row_ptr(rows, vals, block_v)

    hist, wacc = ops.fused_edge_phase(
        *(torch.from_numpy(a) for a in inputs), row_ptr=torch.from_numpy(row_ptr),
        block_v=block_v, k=k, weight_mode=weight_mode)
    want = ref.fused_edge_phase_ref(*inputs, block_v=block_v, k=k,
                                    weight_mode=weight_mode)
    pallas = fused_edge_phase_pallas(
        *(jnp.asarray(a) for a in inputs), block_v=block_v, k=k,
        weight_mode=weight_mode, edge_chunk=chunk, interpret=True)
    walked = walk_rows(dst, vals, row_ptr, labels, lam, actions, feasible,
                       block_v=block_v, k=k, weight_mode=weight_mode)
    for got, w_ref, w_pal, w_walk in zip((hist, wacc), want, pallas, walked):
        np.testing.assert_array_equal(got.numpy(), w_ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w_pal))
        np.testing.assert_array_equal(got.numpy(), w_walk)


def test_fused_edge_phase_rejects_bad_mode():
    z2 = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="weight_mode"):
        ops.fused_edge_phase(z2, z2, z2.float(), torch.zeros(64, dtype=torch.int32),
                             torch.zeros(64, dtype=torch.int32),
                             torch.zeros((1, 64), dtype=torch.int32),
                             torch.zeros((1, 4)), row_ptr=None, block_v=64, k=4,
                             weight_mode="bogus")


# the shapes of tests/test_kernels.py:121, plus an odd k
@pytest.mark.parametrize("v,k,alpha,beta", [
    (16, 4, 1.0, 0.1),
    (300, 8, 0.5, 0.05),
    (64, 32, 1.0, 0.1),
    (50, 5, 1.0, 0.1),
])
def test_la_update_plain(v, k, alpha, beta):
    """Against the float64 oracle and the interpret-mode Pallas kernel, at
    the tolerance tests/test_kernels.py:134 holds the Pallas kernel to."""
    from repro.core.la import split_weights_and_signals

    rng = np.random.default_rng(v + k)
    p = rng.dirichlet(np.ones(k), v).astype(np.float32)
    w, r = (np.array(a) for a in split_weights_and_signals(
        jnp.asarray(rng.uniform(size=(v, k)).astype(np.float32))))
    out = ops.la_update(torch.from_numpy(p), torch.from_numpy(w),
                        torch.from_numpy(r), alpha, beta, renorm=True).numpy()
    want = ref.la_update_ref(p, w, r, alpha=alpha, beta=beta, renorm=True)
    np.testing.assert_allclose(out, want, atol=5e-6, rtol=5e-5)
    pad = (-v) % 8
    pallas = la_update_pallas(
        jnp.asarray(np.pad(p, ((0, pad), (0, 0)), constant_values=1.0 / k)),
        jnp.asarray(np.pad(w, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(r, ((0, pad), (0, 0)))),
        alpha=alpha, beta=beta, renorm=True, block_v=8, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas)[:v], atol=5e-6, rtol=5e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    inputs = row_sorted_slab(rng, 1, 256, 64, 4)
    row_ptr = slab_row_ptr(inputs[1], inputs[2], 64)
    ops.fused_edge_phase(*(torch.from_numpy(a) for a in inputs),
                         row_ptr=torch.from_numpy(row_ptr), block_v=64, k=4)
    p = torch.full((64, 4), 0.25)
    ops.la_update(p, torch.full((64, 4), 0.5), torch.zeros((64, 4)), 1.0, 0.1)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert {"fused_edge_phase", "la_update"} <= set(ops.LAUNCH_COUNTERS)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    p = torch.full((8, 4), 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        la_update.la_update_cuda(p, p, p, 1.0, 0.1)
    z = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        edge_phase.fused_edge_phase_cuda(
            z, z.float(), torch.zeros((1, 65), dtype=torch.int32),
            SpanPlan.from_row_ptr(np.zeros((1, 65), np.int32), "cpu"),
            torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32),
            torch.zeros((1, 64), dtype=torch.int32), torch.zeros((1, 4)),
            block_v=64, k=4)
    with pytest.raises(ValueError, match="no implementation"):
        ops.la_update(p.to("meta"), p.to("meta"), p.to("meta"), 1.0, 0.1)


def test_importing_the_kernels_builds_and_loads_nothing():
    """Import, and a CPU call through every wrapper, with the compiler and
    the library loader made to fail: neither may be reached."""
    code = textwrap.dedent("""
        import ctypes, subprocess
        import torch
        def boom(*a, **k):
            raise AssertionError("build or load attempted")
        subprocess.Popen = boom
        ctypes.CDLL = boom
        from repro_torch.kernels import _build, ops
        p = torch.full((8, 4), 0.25)
        ops.la_update(p, p, torch.zeros((8, 4)), 1.0, 0.1)
        assert _build._libs == {}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
