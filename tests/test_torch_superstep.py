"""Step-by-step parity of the port's Revolver superstep with `repro`'s.

Both packages start from the same state (the JAX state carried across with
`repro_torch.core.convert`) on the golden-worker graph, and the port replays
JAX's own random draws through the ``draws=`` hook: per block the JAX rule
splits ``key, k_act, k_mig = split(key, 3)``, takes the action as
``argmax(logits + gumbel(k_act))`` and the migration uniform from
``uniform(k_mig)``. Labels, lambda and loads must then agree exactly after
every superstep, and the LA probabilities to the kernel tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.device_graph import prepare_device_graph as jax_prepare
from repro.core.revolver import (
    RevolverConfig as JaxConfig,
    revolver_init as jax_init,
    revolver_superstep as jax_superstep,
)
from repro.graphs.generators import dc_sbm as jax_dc_sbm

from repro_torch.core.convert import device_graph_from_numpy, revolver_state_from_numpy
from repro_torch.core.revolver import RevolverConfig, revolver_superstep

# the golden-worker graph (tests/golden_worker.py:31-37)
GRAPH = dict(n=1024, m=8192, n_comm=16, mixing=0.25, degree_exponent=0.5, seed=3)
K, N_BLOCKS, STEPS, SEED = 4, 8, 6, 7


def replayed_draws(key, steps: int, n_blocks: int, block_v: int, k: int):
    """JAX's per-block draws for `steps` supersteps, as numpy, following the
    chunk rule's key chain from the state's key."""
    gumbel = np.empty((steps, n_blocks, block_v, k), np.float32)
    uniform = np.empty((steps, n_blocks, block_v), np.float32)
    for s in range(steps):
        for b in range(n_blocks):
            key, k_act, k_mig = jax.random.split(key, 3)
            gumbel[s, b] = np.asarray(jax.random.gumbel(k_act, (block_v, k)))
            uniform[s, b] = np.asarray(jax.random.uniform(k_mig, (block_v,)))
    return lambda step, blk: (gumbel[step, blk], uniform[step, blk])


@pytest.mark.parametrize("weight_mode", ["self_lambda", "neighbor_lambda"])
def test_superstep_parity_with_replayed_draws(weight_mode):
    g = jax_dc_sbm(**GRAPH)
    dg = jax_prepare(g, n_blocks=N_BLOCKS)
    cfg = JaxConfig(k=K, weight_mode=weight_mode)
    st = jax_init(dg, cfg, jax.random.PRNGKey(SEED))

    dg_t = device_graph_from_numpy(jax.device_get(dg._asdict()), "cpu")
    st_t = revolver_state_from_numpy(jax.device_get(st._asdict()), "cpu", seed=0)
    cfg_t = RevolverConfig(k=K, weight_mode=weight_mode)
    draws = replayed_draws(st.key, STEPS, dg.n_blocks, dg.block_v, K)
    labels0 = st_t.labels.clone()

    for step in range(STEPS):
        st = jax_superstep(dg, cfg, st)
        st_t = revolver_superstep(dg_t, cfg_t, st_t, draws=draws)
        want = jax.device_get(st._asdict())
        for name in ("labels", "lam", "loads"):
            np.testing.assert_array_equal(
                getattr(st_t, name).numpy(), want[name],
                err_msg=f"{name} differs after superstep {step}")
        np.testing.assert_allclose(st_t.probs.numpy(), want["probs"],
                                   atol=5e-6, rtol=5e-5)
        np.testing.assert_allclose(float(st_t.score), float(want["score"]),
                                   rtol=1e-6)
        assert st_t.step == int(want["step"])
    # the trajectory moved: the comparison is not between two frozen states
    assert (st_t.labels != labels0).any()
