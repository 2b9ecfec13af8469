"""The port's copy of the host graph layer builds exactly what `repro`'s
builds: the same CSR arrays and the same padded slabs, so both packages
partition identical inputs."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graphs import blocking as jax_blocking
from repro.graphs import datasets as jax_datasets
from repro.graphs import generators as jax_generators

from repro_torch.graphs import blocking, datasets, generators

SCALE = 0.0005


def assert_same_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["WIKI", "USA", "SO"])
def test_load_dataset_matches_reference(name):
    assert_same_fields(datasets.load_dataset(name, scale=SCALE, seed=1),
                       jax_datasets.load_dataset(name, scale=SCALE, seed=1))


@pytest.mark.parametrize("name", ["WIKI", "USA", "SO"])
def test_block_edges_matches_reference(name):
    g = datasets.load_dataset(name, scale=SCALE)
    assert_same_fields(blocking.block_edges(g, block_v=128),
                       jax_blocking.block_edges(g, block_v=128))


def test_rmat_matches_reference():
    assert_same_fields(generators.rmat(500, 4000, seed=2),
                       jax_generators.rmat(500, 4000, seed=2))


def test_slab_row_ptr_gives_each_row_its_run():
    g = datasets.load_dataset("WIKI", scale=SCALE)
    bl = blocking.block_edges(g, block_v=128)
    ptr = blocking.slab_row_ptr(bl.edge_row, bl.edge_w, bl.block_v)
    assert ptr.shape == (bl.n_blocks, bl.block_v + 1) and ptr.dtype == np.int32
    for b in range(bl.n_blocks):
        for r in range(bl.block_v):
            run = slice(ptr[b, r], ptr[b, r + 1])
            assert (bl.edge_row[b, run] == r).all()
            v = b * bl.block_v + r
            deg = g.adj_ptr[v + 1] - g.adj_ptr[v] if v < g.n else 0
            assert ptr[b, r + 1] - ptr[b, r] == deg
        # everything past the last run is padding
        assert (bl.edge_w[b, ptr[b, -1]:] == 0).all()


def test_slab_row_ptr_rejects_unsorted_slabs():
    rows = np.array([[0, 2, 1, 0]], np.int32)
    w = np.array([[1, 1, 1, 0]], np.float32)
    with pytest.raises(ValueError, match="sorted"):
        blocking.slab_row_ptr(rows, w, 4)
    with pytest.raises(ValueError, match="padding"):
        blocking.slab_row_ptr(np.array([[0, 0, 1, 0]], np.int32),
                              np.array([[1, 0, 1, 0]], np.float32), 4)
