"""The plain reference on graphs checked by hand."""
import numpy as np
import pytest
import torch

from partbench.reference import partition, rules

# 0 -> 1, 1 -> 0, 1 -> 2, 2 -> 3, 3 -> 2, 3 -> 0: two parts {0, 1} and {2, 3}
SRC = np.array([0, 1, 1, 2, 3, 3])
DST = np.array([1, 0, 2, 3, 2, 0])


def graph(src=SRC, dst=DST, n=4):
    from partbench import graphgen

    g = graphgen.csr_arrays(torch.from_numpy(src), torch.from_numpy(dst), n)
    out = {name: (v.numpy() if hasattr(v, "numpy") else v) for name, v in g.items()}
    out["n"] = n
    return out


def test_recount_two_parts():
    c = partition.EdgeList(graph(), "cpu").count(np.array([0, 0, 1, 1]), 2)
    # inside: 0->1, 1->0, 2->3, 3->2; cut: 1->2, 3->0
    assert c.bad_labels == 0
    assert c.local_edges == pytest.approx(4 / 6)
    assert c.loads.tolist() == [3, 3]          # out-degrees 1 + 2 and 1 + 2
    assert c.max_norm_load == pytest.approx(1.0)


def test_recount_all_in_one_part_and_out_of_range():
    edges = partition.EdgeList(graph(), "cpu")
    one = edges.count(np.array([1, 1, 1, 1]), 2)
    assert one.local_edges == 1.0 and one.loads.tolist() == [0, 6]
    assert one.max_norm_load == pytest.approx(2.0)
    bad = edges.count(np.array([0, 5, -1, 1]), 2)
    assert bad.bad_labels == 2
    assert bad.loads.tolist() == [1, 2]        # out-of-range labels count nowhere


def test_layout_weights_and_blocking():
    lay = rules.Layout(graph(), 2, "cpu")
    assert (lay.block_v, lay.n_blocks, lay.n_pad) == (8, 1, 8)
    # symmetrised weights: {0,1} both ways (2), {1,2} one way (1), {2,3}
    # both ways (2), {3,0} one way (1)
    assert lay.inv_wsum[:4].tolist() == pytest.approx([1 / 3, 1 / 3, 1 / 3, 1 / 3])
    assert lay.deg[:4].tolist() == [1, 2, 1, 2]
    assert rules.blocking(1000, 8) == (128, 8)
    assert rules.blocking(1001, 8) == (128, 8)
    assert rules.blocking(17, 8) == (8, 3)


def test_spinner_step_by_hand():
    """Labels (0, 1, 1, 1), loads (1, 5), C = 1.05 * 6 / 2 = 3.15: the
    penalty b/C = (0.317, 1.587) sends vertices 1, 2 and 3 to part 0 (each
    edge-weight sum is 3; vertex 2's neighbourhood is all part 1, tau
    (0, 1), yet 0 - 0.317 > 1 - 1.587). Their out-degrees ask 5 of part 0's
    remaining 2.15, so p_mig(0) = 0.43: a draw of 0 moves, 0.99 does not."""
    lay = rules.Layout(graph(), 1, "cpu")
    st = rules.initial_state(lay, "spinner", np.array([0, 1, 1, 1]), 2)
    assert st["loads"].tolist() == [1.0, 5.0]
    u = torch.full((lay.n_pad,), 0.99)
    u[1] = 0.0
    out = rules.spinner_step(lay, st, lambda step: u, 0, 2, epsilon=0.05)
    assert out["labels"][:4].tolist() == [0, 0, 1, 1]
    assert out["loads"].tolist() == [3.0, 3.0]
    every = rules.spinner_step(lay, st, lambda step: torch.zeros(lay.n_pad), 0, 2, epsilon=0.05)
    assert every["labels"][:4].tolist() == [0, 0, 0, 0]


def test_weighted_la_reward_on_one_slot():
    """A one-hot reward weight on slot 0 with alpha 1 sets p0 to 1 before
    the renorm: the row becomes (1, p1) / (1 + p1)."""
    p = torch.tensor([[0.5, 0.5]])
    w, r = rules.split_weights(torch.tensor([[3.0, 0.0]]), 2)
    assert w.tolist() == [[1.0, 0.0]] and r.tolist() == [[0.0, 1.0]]
    out = rules.weighted_la(p, w, r, 1.0, 0.1)
    assert out[0].tolist() == pytest.approx([1 / 1.5, 0.5 / 1.5])


def test_restream_gate():
    assert rules.unlock(0, 8) == pytest.approx(0.875)
    assert rules.unlock(7, 8) == pytest.approx(0.0, abs=1e-7)


def test_uniform_z():
    assert rules.uniform_z(np.array([0, 1] * 50), 2) == 0.0
    assert rules.uniform_z(np.zeros(100, dtype=np.int64), 2) == pytest.approx(10.0)
