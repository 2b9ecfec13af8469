"""K3, the edge-histogram kernel module, on the CPU: its plain version
against `repro`'s Pallas kernel (interpret mode) and numpy oracle, the
row walk the CUDA kernel performs, the device routing and the launch
counter. The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against its plain version."""
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
from repro.kernels.edge_histogram import edge_histogram_pallas

from repro_torch.core.device_graph import prepare_device_graph
from repro_torch.graphs import load_dataset
from repro_torch.graphs.blocking import slab_row_ptr
from repro_torch.kernels import edge_histogram as k3
from repro_torch.kernels import ops

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
# the tolerance tests/test_kernels.py:35 holds the Pallas kernel to on
# random float values (the sums are taken in other orders)
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def walk_rows(slots, vals, row_ptr, *, block_v, k):
    """The CUDA kernel's algorithm in numpy: each row walks its run
    ``[row_ptr[r], row_ptr[r+1])`` of the slab in order."""
    nb = slots.shape[0]
    hist = np.zeros((nb, block_v, k), np.float32)
    for b in range(nb):
        for r in range(block_v):
            for e in range(row_ptr[b, r], row_ptr[b, r + 1]):
                hist[b, r, slots[b, e]] += vals[b, e]
    return hist


def pallas(slots, rows, vals, *, block_v, k, chunk=256):
    return np.asarray(edge_histogram_pallas(
        jnp.asarray(slots), jnp.asarray(rows), jnp.asarray(vals),
        block_v=block_v, k=k, edge_chunk=chunk, interpret=True))


# the sweep of tests/test_kernels.py:21-36: unsorted rows, float values,
# a padded (zero-valued) tail
@pytest.mark.parametrize("nb,e_max,block_v,k,chunk", [
    (1, 256, 64, 8, 256),
    (3, 512, 128, 16, 256),
    (2, 1024, 256, 32, 512),
])
def test_plain_matches_pallas_on_unsorted_rows(nb, e_max, block_v, k, chunk):
    rng = np.random.default_rng(nb * 1000 + k)
    slots = rng.integers(0, k, (nb, e_max)).astype(np.int32)
    rows = rng.integers(0, block_v, (nb, e_max)).astype(np.int32)
    vals = rng.uniform(0, 2, (nb, e_max)).astype(np.float32)
    vals[:, e_max // 2:] *= (rng.random((nb, e_max - e_max // 2)) > 0.3)
    got = ops.edge_histogram(t(slots), t(rows), t(vals), row_ptr=None,
                             block_v=block_v, k=k).numpy()
    assert got.shape == (nb, block_v, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.edge_histogram_ref(
        slots, rows, vals, block_v=block_v, k=k), **FLOAT_TOL)
    np.testing.assert_allclose(got, pallas(slots, rows, vals, block_v=block_v,
                                           k=k, chunk=chunk), **FLOAT_TOL)


def sorted_slab(rng, nb, e_max, block_v, k, integer: bool):
    """Slabs with the `block_edges` layout: a live, row-sorted prefix (some
    rows empty), then zero-valued padding (row = slot = 0)."""
    slots = np.zeros((nb, e_max), np.int32)
    rows = np.zeros((nb, e_max), np.int32)
    vals = np.zeros((nb, e_max), np.float32)
    for b in range(nb):
        cnt = int(rng.integers(e_max // 2, e_max + 1))
        # every other row may stay empty: rows drawn from the even ones
        rows[b, :cnt] = np.sort(rng.integers(0, block_v // 2, cnt) * 2)
        slots[b, :cnt] = rng.integers(0, k, cnt)
        vals[b, :cnt] = (rng.integers(1, 3, cnt) if integer
                         else rng.uniform(0.01, 2.0, cnt))
    return slots, rows, vals


@pytest.mark.parametrize("integer", [True, False], ids=["eq4", "float"])
@pytest.mark.parametrize("nb,e_max,block_v,k", [
    (1, 256, 64, 1),
    (3, 512, 128, 3),
    (1, 768, 32, 5),
    (3, 512, 64, 8),
    (2, 1024, 256, 13),
])
def test_plain_matches_pallas_and_row_walk_on_sorted_slabs(nb, e_max, block_v, k, integer):
    """On the row-sorted layout the CUDA kernel takes: exact on the eq.-(4)
    weights, within the float tolerance otherwise."""
    rng = np.random.default_rng(nb * 100 + k)
    slots, rows, vals = sorted_slab(rng, nb, e_max, block_v, k, integer)
    row_ptr = slab_row_ptr(rows, vals, block_v)
    got = ops.edge_histogram(t(slots), t(rows), t(vals), row_ptr=t(row_ptr),
                             block_v=block_v, k=k).numpy()
    want = [ref.edge_histogram_ref(slots, rows, vals, block_v=block_v, k=k),
            pallas(slots, rows, vals, block_v=block_v, k=k),
            walk_rows(slots, vals, row_ptr, block_v=block_v, k=k)]
    for w in want:
        if integer:
            np.testing.assert_array_equal(got, w)
        else:
            np.testing.assert_allclose(got, w, **FLOAT_TOL)
    assert (got[:, 1::2] == 0).all()      # the empty rows


@pytest.mark.parametrize("k", [4, 8])
def test_device_graph_slabs_with_labels_are_exact(k):
    """The rules' own input: a `DeviceGraph`'s padded slabs, the neighbors'
    labels as slots and the eq.-(4) weights as values."""
    dg = prepare_device_graph(load_dataset("WIKI", scale=0.0005), n_blocks=4,
                              device="cpu")
    labels = torch.from_numpy(
        np.random.default_rng(k).integers(0, k, dg.n_pad).astype(np.int32))
    slots = labels[dg.blk_dst]
    got = ops.edge_histogram(slots, dg.blk_row, dg.blk_w, row_ptr=dg.blk_row_ptr,
                             block_v=dg.block_v, k=k).numpy()
    args = (slots.numpy(), dg.blk_row.numpy(), dg.blk_w.numpy())
    np.testing.assert_array_equal(got, ref.edge_histogram_ref(
        *args, block_v=dg.block_v, k=k))
    np.testing.assert_array_equal(got, pallas(*args, block_v=dg.block_v, k=k))
    np.testing.assert_array_equal(got, walk_rows(
        args[0], args[2], dg.blk_row_ptr.numpy(), block_v=dg.block_v, k=k))
    assert (dg.blk_w == 0).any()          # the layout has padding


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    slots, rows, vals = sorted_slab(rng, 2, 256, 64, 4, True)
    ops.edge_histogram(t(slots), t(rows), t(vals),
                       row_ptr=t(slab_row_ptr(rows, vals, 64)), block_v=64, k=4)
    assert ops.launch_counts()["edge_histogram"] == 0
    assert ops.LAUNCH_COUNTERS["edge_histogram"] is k3.LAUNCHES


def test_gather_form_on_the_cpu_takes_the_plain_version_and_counts_no_launch():
    """``labels=`` (the rules' gather form) on CPU tensors: the plain version
    on labels[dst], no launch of either route."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(1)
    _, rows, vals = sorted_slab(rng, 2, 256, 64, 4, True)
    dst = rng.integers(0, 500, rows.shape).astype(np.int32)
    labels = rng.integers(0, 4, 500).astype(np.int32)
    got = ops.edge_histogram(t(dst), t(rows), t(vals), labels=t(labels),
                             row_ptr=t(slab_row_ptr(rows, vals, 64)), spans=None,
                             block_v=64, k=4, integer_values=True)
    want = k3.edge_histogram_plain(t(labels[dst]), t(rows), t(vals), block_v=64, k=4)
    assert torch.equal(got, want)
    assert ops.launch_counts()["edge_histogram"] == 0
    assert ops.launch_counts()["edge_histogram_float"] == 0
    assert ops.LAUNCH_COUNTERS["edge_histogram_float"] is k3.FLOAT_LAUNCHES


def test_the_gather_form_needs_the_integer_value_statement():
    z = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="integer_values"):
        ops.edge_histogram(z, z, z.float(), labels=torch.zeros(4, dtype=torch.int32),
                           row_ptr=None, block_v=64, k=4)


def test_wrappers_refuse_other_devices_and_bad_k():
    z = torch.zeros((1, 256), dtype=torch.int32)
    ptr = torch.zeros((1, 65), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k3.edge_histogram_cuda(z, z.float(), ptr, block_v=64, k=4)
    with pytest.raises(ValueError, match="CUDA"):
        k3.edge_histogram_spans_cuda(z, z.float(), ptr, None, block_v=64, k=4)
    with pytest.raises(ValueError, match="no implementation"):
        ops.edge_histogram(z.to("meta"), z.to("meta"), z.float().to("meta"),
                           row_ptr=ptr.to("meta"), block_v=64, k=4)
    with pytest.raises(ValueError, match="k"):
        ops.edge_histogram(z, z, z.float(), row_ptr=ptr, block_v=64, k=0)
    for k in (0, k3.MAX_K + 1):
        with pytest.raises(ValueError, match=f"got k={k}"):
            k3.edge_histogram_cuda(z, z.float(), ptr, block_v=64, k=k)


def test_importing_and_a_cpu_call_build_and_load_nothing():
    """Import, and a CPU call through the wrapper, with the compiler and the
    library loader made to fail: neither may be reached."""
    code = textwrap.dedent("""
        import ctypes, subprocess
        import torch
        def boom(*a, **k):
            raise AssertionError("build or load attempted")
        subprocess.Popen = boom
        ctypes.CDLL = boom
        from repro_torch.kernels import _build, edge_histogram, ops
        z = torch.zeros((1, 256), dtype=torch.int32)
        ops.edge_histogram(z, z, z.float(), row_ptr=None, block_v=64, k=4)
        assert _build._libs == {}
        assert "edge_histogram" in _build.KERNELS
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
