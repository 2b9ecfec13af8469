"""The port's training losses and their gradients on the CPU against
`repro`, from the same parameters and batches (`repro`'s reduced init from
seed 0, every leaf redrawn around itself with numpy, converted into the
port; batches drawn with numpy): `lm_loss` + autograd against
``jax.value_and_grad(repro.models.lm_loss)`` for all ten archs,
`chunked_cross_entropy` alone, remat, the route under autograd (the
kernel wrappers refuse it), and the parameter-tree conversion both ways.

Tolerances: f32 losses to 1e-5 relative; each f32 gradient leaf within
1e-4 of its own L2 norm (the frameworks sum in other orders). A leaf whose
reference gradient is zero up to rounding (below 1e-6 of the global norm:
Whisper's key biases, to which the row softmax is blind) is held to 1e-6
of the global norm instead. bf16: loss to 1e-2 relative, each leaf's
relative L2 error below 5e-2."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.models import common as jcommon
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import rwkv6 as jrwkv6

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon
from repro_torch.models import init_lm, lm_loss
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                        lm_params_to_tree, param_path, tree_to_named)

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
ZERO_TOL = 1e-6
BF16_LOSS_RTOL = 1e-2
BF16_LEAF_TOL = 5e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """`repro`'s reduced parameters of ``arch`` (in ``dtype``) from seed 0,
    every leaf redrawn as N(leaf, std(leaf)^2) (std 0.1 for a constant
    leaf); made once a worker, callers copy before changing."""
    cfg = jregistry.get_config(arch).reduced(param_dtype=dtype, compute_dtype=dtype)
    rng = np.random.default_rng(0)
    tree = _np_tree(jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0)))
    return jax.tree.map(
        lambda a: (a.astype(np.float32) + rng.standard_normal(a.shape)
                   * (float(a.astype(np.float32).std()) or 0.1)).astype(a.dtype), tree)


def _tree(arch, dtype="float32"):
    return jax.tree.map(np.copy, _params(arch, dtype))


def _batch(cfg, seed=1, b=3, s=32):
    """tokens, labels (row 0's first 5 masked) and a VLM's or Whisper's
    stub frontend, numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :5] = -100
    if cfg.family in ("vlm", "encdec"):
        n = cfg.n_patches or cfg.enc_seq
        batch["frontend"] = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    return batch


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _repro_value_and_grad(jcfg, tree, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jcfg, jb), has_aux=True))(tree)
    return float(loss), _flat(_np_tree(grads))


def _port_value_and_grad(cfg, model, batch):
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss, metrics = lm_loss(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["loss"] is loss and loss.dtype == torch.float32 and loss.dim() == 0
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    named = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, grads)}
    return float(loss.detach()), _flat(lm_params_to_numpy(named))


def _configs(arch, **changes):
    return (jregistry.get_config(arch).reduced(**changes),
            registry.get_config(arch).reduced(**changes))


# --------------------------------------------------------------------------
# lm_loss and its gradients, every arch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_lm_loss_and_grads_match_repro(arch):
    """f32: `lm_loss` and every gradient leaf against `repro`'s
    ``jax.value_and_grad``, through `lm_params_to_numpy`. S = 32 (a whole
    number of RWKV and Mamba2 chunks; a VLM's 8 patches make 40, which the
    loss's chunk of 16 does not divide, so it halves to 8)."""
    jcfg, cfg = _configs(arch)
    tree = _tree(arch)
    batch = _batch(cfg)
    want_loss, want = _repro_value_and_grad(jcfg, tree, batch)
    got_loss, got = _port_value_and_grad(cfg, lm_params_from_numpy(cfg, tree, "cpu"), batch)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert set(got) == set(want)
    gnorm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in want.values()))
    for path, w in want.items():
        wn = float(np.linalg.norm(w))
        if wn < ZERO_TOL * gnorm:              # zero up to rounding in both
            assert float(np.linalg.norm(got[path])) < ZERO_TOL * gnorm, path
        else:
            err = float(np.abs(got[path] - w).max())
            assert err <= LEAF_TOL * wn, (path, err, wn)


def test_lm_loss_and_grads_bf16_match_repro():
    """bf16 parameters and activations (reduced tinyllama, GQA): the loss
    to 1e-2 relative, each gradient leaf to 5e-2 relative L2."""
    gqa = dict(n_heads=8, n_kv=2, d_model=128)
    jcfg, cfg = _configs("tinyllama-1.1b", param_dtype="bfloat16", compute_dtype="bfloat16",
                         **gqa)
    tree = _np_tree(jax.jit(jinit_lm, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    want_loss, want = _repro_value_and_grad(jcfg, tree, batch)
    model = lm_params_from_numpy(cfg, tree, "cpu")
    assert model.embed.emb.dtype == torch.bfloat16
    got_loss, got = _port_value_and_grad(cfg, model, batch)
    assert abs(got_loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    for path, w in want.items():
        rel = float(np.linalg.norm(got[path] - w) / np.linalg.norm(w))
        assert rel < BF16_LEAF_TOL, (path, rel)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b", "zamba2-7b", "whisper-base",
                                  "deepseek-v2-lite-16b"])
def test_remat_changes_neither_loss_nor_grads(arch):
    """``remat=True`` (each block, and the hybrid's groups, recomputed in
    backward) gives the loss and gradients of ``remat=False``, bit for
    bit: the recomputation is the same forward."""
    _, cfg = _configs(arch)
    tree = _tree(arch)
    batch = _batch(cfg)
    out = [_port_value_and_grad(c, lm_params_from_numpy(c, tree, "cpu"), batch)
           for c in (cfg, dataclasses.replace(cfg, remat=True))]
    assert out[0][0] == out[1][0]
    for path, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][path], g, err_msg=path)


# --------------------------------------------------------------------------
# chunked_cross_entropy alone
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk,logit_scale,masked_rows", [
    (24, 16, 1.0, ()),          # 16 does not divide 24: halved to 8
    (20, 512, 0.0625, (1,)),    # command-r's scale; a row wholly masked
    (12, 5, 1.0, (0, 1)),       # halved 5 -> 2; two of three rows masked
])
def test_chunked_cross_entropy_matches_repro(s, chunk, logit_scale, masked_rows):
    rng = np.random.default_rng(s)
    b, d, v = 3, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[list(masked_rows)] = -100
    labels[2, ::3] = -100

    def jloss(hh, ee):
        return jcommon.chunked_cross_entropy(hh, ee, jnp.asarray(labels), chunk=chunk,
                                             logit_scale=logit_scale)

    want, (wgh, wge) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    got = tcommon.chunked_cross_entropy(th, te, torch.from_numpy(labels), chunk=chunk,
                                        logit_scale=logit_scale)
    gh, ge = torch.autograd.grad(got, (th, te))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wgh), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(wge), atol=1e-6, rtol=1e-5)


def test_chunked_cross_entropy_all_masked_is_zero():
    """No unmasked label: the count is clamped to 1 and the loss is 0, with
    zero gradients, as in `repro`."""
    h = torch.randn(2, 8, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    emb = torch.randn(10, 4, generator=torch.Generator().manual_seed(1))
    labels = torch.full((2, 8), -100, dtype=torch.int32)
    loss = tcommon.chunked_cross_entropy(h, emb, labels, chunk=4)
    (g,) = torch.autograd.grad(loss, (h,))
    assert float(loss.detach()) == 0.0 and float(g.abs().max()) == 0.0
    want = jcommon.chunked_cross_entropy(jnp.asarray(h.detach().numpy()), jnp.asarray(emb.numpy()),
                                         jnp.asarray(labels.numpy()), chunk=4)
    assert float(want) == 0.0


# --------------------------------------------------------------------------
# the route under autograd
# --------------------------------------------------------------------------
def _kernel_inputs():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, 16, generator=gen)
    k = torch.randn(2, 2, 8, 16, generator=gen)
    v = torch.randn(2, 2, 8, 16, generator=gen)
    r = torch.randn(2, 5, 2, 8, generator=gen)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v)),
        "decode_attention": (ops.decode_attention,
                             (q[:, :, 0], k, v, torch.tensor([8, 3], dtype=torch.int32))),
        "wkv6": (ops.wkv6, (r, r.clone(), r.clone(), -torch.rand(2, 5, 2, 8, generator=gen),
                            torch.randn(2, 8, generator=gen), torch.zeros(2, 2, 8, 8))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "wkv6"])
def test_kernel_wrappers_refuse_autograd(name):
    """K4, K5 and K6 have no backward: their wrappers raise when grad mode
    is on and an input requires grad (on the CPU as on the card), and run
    under `torch.no_grad` or without grad-requiring inputs."""
    fn, args = _kernel_inputs()[name]
    fn(*args)                                           # nothing requires grad
    grad_args = [a.clone().requires_grad_(True) if a.is_floating_point() else a for a in args]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args)
    with torch.no_grad():
        fn(*grad_args)
    with torch.inference_mode():
        fn(*args)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b", "deepseek-v2-236b",
                                  "rwkv6-3b", "zamba2-7b", "whisper-base", "internvl2-1b"])
def test_grad_route_loss_equals_serving_route(arch):
    """On the CPU the forward under autograd (the chunked attention, the
    out-of-place RWKV6 scan) gives the loss the serving route (the
    kernels' plain versions) gives, without grad."""
    _, cfg = _configs(arch)
    model = lm_params_from_numpy(cfg, _tree(arch), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        serve_loss, _ = lm_loss(model, cfg, batch)
    model.requires_grad_(True)
    train_loss, _ = lm_loss(model, cfg, batch)
    assert train_loss.requires_grad and not serve_loss.requires_grad
    np.testing.assert_allclose(float(train_loss.detach()), float(serve_loss), rtol=1e-6)


def test_wkv6_scan_matches_repro_and_leaves_the_state():
    """`wkv6_scan` (the RWKV6 recurrence under autograd) equals `repro`'s
    ``_wkv_scan`` from a nonzero state, returns a new state and leaves the
    given one as it was; its gradients equal `repro`'s."""
    rng = np.random.default_rng(3)
    b, s, h, n = 2, 7, 2, 8
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, n))).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    st = rng.standard_normal((b, h, n, n)).astype(np.float32)

    def jf(r_, k_, v_):
        y, state = jrwkv6._wkv_scan(r_, k_, v_, jnp.asarray(logw), jnp.asarray(u),
                                    jnp.asarray(st))
        return jnp.sum(y * y) + jnp.sum(state), (y, state)

    (_, (wy, wst)), wg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(r), jnp.asarray(k), jnp.asarray(v))
    tr, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (r, k, v))
    st0 = torch.from_numpy(st.copy())
    y, state = trwkv6.wkv6_scan(tr, tk, tv, torch.from_numpy(logw), torch.from_numpy(u), st0)
    np.testing.assert_array_equal(st0.numpy(), st)
    assert state is not st0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.detach().numpy(), np.asarray(wst), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad((y * y).sum() + state.sum(), (tr, tk, tv))
    for got, want in zip(grads, wg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


# --------------------------------------------------------------------------
# the parameter tree, both ways
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_params_round_trip_bit_equal(arch):
    """`lm_params_to_numpy` inverts `lm_params_from_numpy` both ways, bit
    for bit: `repro`'s tree -> the port -> the same tree (keys, shapes,
    dtypes, values), and a randomly initialised port model -> a tree -> the
    same model; `tree_to_named` splits a tree back onto the names."""
    _, cfg = _configs(arch)
    tree = _tree(arch)
    back = lm_params_to_numpy(lm_params_from_numpy(cfg, tree, "cpu"))
    want, got = _flat(tree), _flat(back)
    assert set(got) == set(want)
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        g = got[jax.tree_util.keystr(path)]
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    model = init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    again = lm_params_from_numpy(cfg, lm_params_to_numpy(model), "cpu")
    named = tree_to_named(model, lm_params_to_tree(model))
    for (name, p), (name2, q) in zip(model.named_parameters(), again.named_parameters()):
        assert name == name2 and p.dtype == q.dtype
        assert torch.equal(p, q) and torch.equal(named[name], p)


def test_param_path_and_bf16_leaves():
    """A name's path drops its stacked indices (two for the hybrid's Mamba2
    layers); bf16 leaves come back as bf16 numpy arrays, bit for bit."""
    assert param_path("blocks.3.attn.wq.w") == (("blocks", "attn", "wq", "w"), (3,))
    assert param_path("mamba.1.0.ln.g") == (("mamba", "ln", "g"), (1, 0))
    assert param_path("embed.emb") == (("embed", "emb"), ())
    tree = _tree("tinyllama-1.1b", "bfloat16")
    cfg = registry.get_config("tinyllama-1.1b").reduced(param_dtype="bfloat16",
                                                         compute_dtype="bfloat16")
    back = lm_params_to_numpy(lm_params_from_numpy(cfg, tree, "cpu"))
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        g = back
        for key in path:
            g = g[key.key]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint16), w.view(np.uint16))


def test_to_tree_refuses_a_broken_stack():
    _, cfg = _configs("tinyllama-1.1b")
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    named = {n: p for n, p in model.named_parameters() if not n.startswith("blocks.0.")}
    with pytest.raises(ValueError, match="not a full stack"):
        lm_params_to_tree(named)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_train_config_fields_match_repro(arch):
    """``remat`` and ``logits_chunk``: `repro`'s defaults at full size and
    its reduced values (False, 16)."""
    for ours, theirs in ((registry.get_config(arch), jregistry.get_config(arch)),
                         (registry.get_config(arch).reduced(), jregistry.get_config(arch).reduced())):
        assert (ours.remat, ours.logits_chunk) == (theirs.remat, theirs.logits_chunk)
    assert (registry.get_config(arch).remat, registry.get_config(arch).logits_chunk) == (True, 512)
