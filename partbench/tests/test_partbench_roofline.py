"""The byte counts of the roofline shares, against the kernel table's bounds."""
import pytest

from partbench import roofline

WIKI_BLOCK0 = 7_691_830      # slab entries of block 0 of the full WIKI layout
WIKI_BV = 224_184            # its block_v (8 blocks)


def ms(nbytes):
    return nbytes / roofline.HBM_BYTES_PER_S * 1e3


def test_k1_bound_at_wiki_block0():
    assert ms(roofline.k1_bytes(WIKI_BLOCK0, WIKI_BV, 8 * WIKI_BV, 8)) == pytest.approx(
        0.0275, abs=5e-5)


def test_k2_counts_the_probabilities_in_and_out():
    # the kernel table's 0.00857 ms: the probabilities in and out, and the
    # weights and signals read
    assert ms(roofline.k2_bytes(WIKI_BV, 8)) == pytest.approx(0.00857, abs=5e-6)
    assert roofline.k2_bytes(WIKI_BV, 8) == 4 * WIKI_BV * 8 * 4


def test_k3_gather_form_adds_the_labels():
    slots = roofline.k3_bytes(1000, 2, 64, 8, 128) - 128 * 4
    assert slots == 1000 * 8 + 2 * 65 * 4 + 2 * 64 * 8 * 4


@pytest.mark.parametrize("algo,kernels", [("revolver", {"k1", "k2"}), ("restream", {"k3"}),
                                          ("spinner", {"k3"})])
def test_kernel_bytes_per_superstep(algo, kernels):
    out = roofline.kernel_bytes_per_superstep(algo, [10, 20, 30], 16, 48, 8)
    assert set(out) == kernels
    if algo == "spinner":
        assert out["k3"] == roofline.k3_bytes(60, 3, 16, 8, 48)
    if algo == "restream":
        assert out["k3"] == sum(roofline.k3_bytes(x, 1, 16, 8, 48) for x in (10, 20, 30))


def test_superstep_bytes_order():
    args = (1000, 128, 8)
    spin, rest, rev = (roofline.superstep_bytes(a, *args) for a in ("spinner", "restream",
                                                                    "revolver"))
    assert spin < rest < rev
    assert rev - spin == 2 * 128 * 4 + 2 * 128 * 8 * 4
    with pytest.raises(ValueError):
        roofline.superstep_bytes("hash", *args)


def test_share_is_none_without_a_time():
    assert roofline.share_pct(1e9, 0.0) is None
    assert roofline.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
