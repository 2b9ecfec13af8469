"""The port's optimizer, train step, data pipeline, trainer and training
CLI on the CPU against `repro`, from the same parameters (`repro`'s reduced
init converted into the port) and the same batches: one AdamW step, the
schedule and the clip; one train step at microbatch 1 and 4 against
`repro`'s jitted step; `make_batch` bit-equal; resume bit-exact after a
simulated failure, through the `Trainer` and through the CLI; checkpoints
crossing between `repro`'s trainer and the port's both ways; the serving
CLI restoring only the parameters of a trainer checkpoint; the utils.

Tolerances: AdamW alone (the same gradients in) to 1e-6 relative. A train
step: loss and grad norm to 1e-5 relative; the moments within 1e-5 of each
leaf's largest magnitude; parameters and masters to 1e-5 absolute (2 % of
the learning rate: at step 1 Adam moves every element by about lr, so an
element whose gradient is near 0 magnifies the frameworks' rounding)."""
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.data import DataConfig as JDataConfig
from repro.data import PrefetchLoader as JPrefetchLoader
from repro.data import make_batch as jmake_batch
from repro.models import init_lm as jinit_lm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import schedule as jschedule
from repro.train import Trainer as JTrainer
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step

from repro_torch.checkpoint import latest_step, load_checkpoint_tensors, save_checkpoint
from repro_torch.configs import registry
from repro_torch.data import DataConfig, PrefetchLoader, make_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import init_lm
from repro_torch.models.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.optim import (OptConfig, adamw_update, clip_by_global_norm, init_opt_state,
                               schedule)
from repro_torch.serve import Engine, cache_rows
from repro_torch.train import (SimulatedFailure, Trainer, init_train_state, make_decode_step,
                               make_prefill_step, make_train_step, restore_train_state,
                               train_state, train_state_tree)
from repro_torch.utils import (MetricLogger, fold_in_str, tree_bytes, tree_global_norm,
                               tree_param_count)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
GQA = dict(n_heads=8, n_kv=2, d_model=128)
# eps 1e-6 for the steps held to `repro`'s: at the first step Adam's
# g / (|g| + eps) magnifies a gradient's rounding by up to 1 / eps where
# |g| ~ eps (the formula itself is held at eps 1e-8 by the AdamW tests)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
ADAM_RTOL = 1e-6
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(arch, **changes):
    return (jregistry.get_config(arch).reduced(**changes),
            registry.get_config(arch).reduced(**changes))


def _data(cfg, **changes):
    kw = dict(vocab=cfg.vocab, seq_len=32, batch_per_host=8, v_eff=64,
              frontend=((cfg.n_patches or cfg.enc_seq, cfg.d_model)
                        if cfg.family in ("vlm", "encdec") else None))
    kw.update(changes)
    return kw


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def _grads(rng, scale):
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": (rng.standard_normal((11,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0])      # below and above clip_norm
def test_adamw_update_matches_repro(scale):
    """Two AdamW steps from the same masters and gradients: masters, m, v,
    count, lr, grad norm and the bf16 parameters against `repro`'s."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((11,)).astype(np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1, clip_norm=1.0)
    jstate = jinit_opt_state({k: jnp.asarray(v) for k, v in params.items()})
    tstate = init_opt_state({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(2):
        g = _grads(rng, scale)
        jp, jstate, jm = jadamw_update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                       JOptConfig(**cfg), param_dtype=jnp.bfloat16)
        tp, tstate, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                                      OptConfig(**cfg), param_dtype=torch.bfloat16)
        for key in ("master", "m", "v"):
            for n in params:
                np.testing.assert_allclose(tstate[key][n].numpy(), np.asarray(jstate[key][n]),
                                           rtol=ADAM_RTOL, atol=1e-12, err_msg=f"{key}/{n}")
        for n in params:
            assert tp[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(tp[n].float().numpy(),
                                          np.asarray(jp[n]).astype(np.float32))
        assert int(tstate["count"]) == int(jstate["count"])
        assert tstate["count"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=ADAM_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=ADAM_RTOL)


def test_schedule_matches_repro():
    """Warmup, cosine and the floor past total_steps, steps 0 to total + 5."""
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_frac=0.1)
    for step in range(0, 46):
        got = schedule(OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        want = jschedule(JOptConfig(**cfg), jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=ADAM_RTOL, err_msg=str(step))
    assert float(schedule(OptConfig(**cfg), 3)) == pytest.approx(3e-4 * 3 / 7)


@pytest.mark.parametrize("scale,clipped", [(0.01, False), (10.0, True)])
def test_clip_by_global_norm_matches_repro(scale, clipped):
    g = _grads(np.random.default_rng(1), scale)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    want, jnorm = jclip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=ADAM_RTOL)
    assert (float(norm) > 1.0) == clipped
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=ADAM_RTOL)
    if not clipped:
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), g[k])


def test_init_opt_state_layout():
    """f32 master copies (not aliases, even of f32 parameters), zero
    moments, an int32 count; ``ef_err`` only with compression."""
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "f": torch.ones(4)}
    st = init_opt_state(p)
    assert set(st) == {"master", "m", "v", "count"}
    assert st["master"]["f"].data_ptr() != p["f"].data_ptr()
    assert all(t.dtype == torch.float32 for k in ("master", "m", "v") for t in st[k].values())
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    ef = init_opt_state(p, ef_compression=True)
    assert set(ef["ef_err"]) == {"w", "f"} and float(ef["ef_err"]["w"].abs().sum()) == 0


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
def _repro_and_port_step(arch, microbatch, changes, seed=0):
    jcfg, cfg = _configs(arch, **changes)
    params = _np_tree(jax.jit(jinit_lm, static_argnums=0)(jcfg, jax.random.PRNGKey(seed)))
    batch = make_batch(DataConfig(**_data(cfg)), 0)
    jstate = {"params": params, "opt": jinit_opt_state(params), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(jmake_train_step(jcfg, JOptConfig(**OPT), microbatch=microbatch))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state(lm_params_from_numpy(cfg, params, "cpu"))
    state, m = make_train_step(cfg, OptConfig(**OPT), microbatch=microbatch)(state, batch)
    return jstate, jm, state, m


@pytest.mark.parametrize("arch,microbatch,changes", [
    ("tinyllama-1.1b", 1, GQA),
    ("tinyllama-1.1b", 4, GQA),
    ("internvl2-1b", 2, {}),        # the patches' frontend split with the tokens
])
def test_train_step_matches_repro(arch, microbatch, changes):
    """One step from the same converted state and batch against `repro`'s
    jitted step: loss, grad norm, lr, count, the moments, masters and
    parameters."""
    jstate, jm, state, m = _repro_and_port_step(arch, microbatch, changes)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=STEP_RTOL, err_msg=key)
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert int(state["opt"]["count"]) == 1
    for key in ("m", "v"):
        got, want = _flat(lm_params_to_numpy(state["opt"][key])), _flat(_np_tree(jstate["opt"][key]))
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_array_less(np.abs(got[path] - w), STEP_RTOL * np.abs(w).max() + 1e-30)
    for got_tree, want_tree in ((state["params"], jstate["params"]),
                                (state["opt"]["master"], jstate["opt"]["master"])):
        got, want = _flat(lm_params_to_numpy(got_tree)), _flat(_np_tree(want_tree))
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=PARAM_ATOL, rtol=0, err_msg=path)


def test_microbatch_accumulation_matches_full_batch():
    """The port's step at microbatch 2 and 4 against its step at 1 (f32
    accumulation), as `repro`'s own test holds `repro`'s."""
    _, cfg = _configs("tinyllama-1.1b", **GQA)
    batch = make_batch(DataConfig(**_data(cfg)), 0)
    out = {}
    for mb in (1, 2, 4):
        state = init_train_state(cfg, OptConfig(**OPT), 0, "cpu")
        state, m = make_train_step(cfg, OptConfig(**OPT), microbatch=mb)(state, batch)
        out[mb] = (float(m["loss"]), lm_params_to_numpy(state["params"]))
    for mb in (2, 4):
        np.testing.assert_allclose(out[mb][0], out[1][0], rtol=STEP_RTOL)
        for (p, a), (_, b) in zip(_flat(out[1][1]).items(), _flat(out[mb][1]).items()):
            np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=1e-4, err_msg=p)


def test_prefill_and_decode_step_factories():
    """The thin serving factories give `Engine`'s greedy tokens."""
    _, cfg = _configs("tinyllama-1.1b", **GQA)
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, 16)(model, {"tokens": prompts})
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(3):
            logits, cache = make_decode_step(cfg)(model, cache, toks[-1])
            toks.append(torch.argmax(logits, -1).to(torch.int32))
    want = Engine(cfg, model, s_max=16).generate(prompts, max_new=4).tokens
    assert torch.equal(torch.stack(toks, 1), want)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("frontend", [None, (8, 32)])
def test_make_batch_bit_equal_to_repro(frontend):
    kw = dict(vocab=1000, seq_len=17, batch_per_host=3, seed=5, v_eff=300, frontend=frontend)
    for step, host in ((0, 0), (7, 0), (3, 2)):
        got = make_batch(DataConfig(**kw), step, host)
        want = jmake_batch(JDataConfig(**kw), step, host)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    loader, jloader = PrefetchLoader(DataConfig(**kw), start_step=4), \
        JPrefetchLoader(JDataConfig(**kw), start_step=4)
    try:
        for _ in range(3):
            (s1, b1), (s2, b2) = next(loader), next(jloader)
            assert s1 == s2
            np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    finally:
        loader.close()
        jloader.close()


# --------------------------------------------------------------------------
# the trainer, its checkpoints and the CLI
# --------------------------------------------------------------------------
def _trainer(cfg, ckpt_dir, **kw):
    return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                   DataConfig(**_data(cfg, batch_per_host=4, seq_len=16)), ckpt_dir=ckpt_dir,
                   logger=MetricLogger(stream=io.StringIO()), device="cpu", **kw)


def _state_arrays(state):
    tree = train_state_tree(state)
    return {f"{k}{p}": np.asarray(v) for k in ("params", "opt")
            for p, v in _flat(jax.tree.map(lambda t: t.detach().float().numpy(),
                                           tree[k])).items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base"])
def test_trainer_resumes_bit_exact_after_simulated_failure(arch, tmp_path):
    """A failure injected at step 4 (checkpoints every 2 steps), a new
    Trainer resuming from step 4: parameters, masters, moments, count and
    the loss history bit-equal to an uninterrupted run's."""
    _, cfg = _configs(arch)
    whole = _trainer(cfg, str(tmp_path / "a"), ckpt_every=2).init_or_resume(0)
    hist = whole.run(6)
    first = _trainer(cfg, str(tmp_path / "b"), ckpt_every=2, inject_failure_at=4)
    first.init_or_resume(0)
    with pytest.raises(SimulatedFailure):
        first.run(6)
    assert latest_step(str(tmp_path / "b")) == 4
    second = _trainer(cfg, str(tmp_path / "b"), ckpt_every=2).init_or_resume(0)
    assert second.step == 4
    tail = second.run(6)
    assert tail == hist[4:]
    got, want = _state_arrays(second.state), _state_arrays(whole.state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(second.state["opt"]["count"]) == 6 == int(second.state["step"])
    assert latest_step(str(tmp_path / "b")) == 6
    assert [c["step"] for c in second.checkpoints] == [6]
    assert all(c["write_s"] > 0 for c in whole.checkpoints)


def test_trainer_checkpoint_is_repros_layout_and_resumes_in_repro(tmp_path):
    """The port's checkpoint holds `repro`'s train-state keys, shapes and
    dtypes; `repro`'s Trainer resumes from it, and its next step equals
    the port's next step."""
    jcfg, cfg = _configs("tinyllama-1.1b", **GQA)
    ckpt = str(tmp_path)
    port = _trainer(cfg, ckpt, ckpt_every=2).init_or_resume(0)
    port.run(2)
    like = jax.eval_shape(lambda k: jinit_train_state(jcfg, JOptConfig(**OPT), k),
                          jax.random.PRNGKey(0))
    from repro.checkpoint.store import load_manifest as jload_manifest
    keys = jload_manifest(ckpt, 2)["keys"]
    want = {"/".join(str(getattr(k, "key", k)) for k in p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_leaves_with_path(like)}
    assert {k: (tuple(v["shape"]), v["dtype"]) for k, v in keys.items()} == want
    jt = JTrainer(jcfg, port.opt_cfg, JDataConfig(**dataclasses.asdict(port.data_cfg)),
                  ckpt_dir=ckpt, ckpt_every=100, logger=MetricLogger(stream=io.StringIO()))
    jt.init_or_resume(jax.random.PRNGKey(0))
    assert jt.step == 2
    jhist = jt.run(3)
    hist = port.run(3)
    np.testing.assert_allclose(hist, jhist, rtol=STEP_RTOL)
    got, want = _flat(lm_params_to_numpy(port.state["params"])), _flat(_np_tree(jt.state["params"]))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=PARAM_ATOL, rtol=0, err_msg=path)


def test_repro_checkpoint_resumes_in_port_trainer(tmp_path):
    """A reduced checkpoint that `repro`'s Trainer wrote (step 2) resumes
    in the port's Trainer; one step after it equals `repro`'s next step."""
    jcfg, cfg = _configs("tinyllama-1.1b", **GQA)
    ckpt = str(tmp_path)
    data = _data(cfg, batch_per_host=4, seq_len=16)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    jt = JTrainer(jcfg, JOptConfig(**opt), JDataConfig(**data), ckpt_dir=ckpt, ckpt_every=2,
                  logger=MetricLogger(stream=io.StringIO()))
    jt.init_or_resume(jax.random.PRNGKey(0))
    jt.run(2)
    port = _trainer(cfg, ckpt, ckpt_every=100).init_or_resume(123)
    assert port.step == 2 and int(port.state["opt"]["count"]) == 2
    np.testing.assert_array_equal(
        _flat(lm_params_to_numpy(port.state["params"]))["['embed']['emb']"],
        np.asarray(jt.state["params"]["embed"]["emb"]))
    jhist = jt.run(3)
    hist = port.run(3)
    np.testing.assert_allclose(hist, jhist, rtol=STEP_RTOL)
    for key in ("m", "v"):
        got = _flat(lm_params_to_numpy(port.state["opt"][key]))
        for path, w in _flat(_np_tree(jt.state["opt"][key])).items():
            np.testing.assert_array_less(np.abs(got[path] - w), STEP_RTOL * np.abs(w).max() + 1e-30)
    got = _flat(lm_params_to_numpy(port.state["opt"]["master"]))
    for path, w in _flat(_np_tree(jt.state["opt"]["master"])).items():
        np.testing.assert_allclose(got[path], w, atol=PARAM_ATOL, rtol=0, err_msg=path)


def test_restore_refuses_a_mismatched_checkpoint(tmp_path):
    _, cfg = _configs("tinyllama-1.1b", **GQA)
    state = init_train_state(cfg, OptConfig(**OPT), 0, "cpu")
    tree = train_state_tree(state)
    tree["opt"]["m"]["embed"]["emb"] = tree["opt"]["m"]["embed"]["emb"][:, :3]
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="opt/m of embed.emb"):
        restore_train_state(cfg, str(tmp_path), 1, "cpu")
    _, other = _configs("rwkv6-3b")
    with pytest.raises(ValueError, match="does not match"):
        restore_train_state(other, str(tmp_path), 1, "cpu")


def _run_cli(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m"] + args, cwd=os.path.dirname(SRC), env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_exits_42_then_resumes(tmp_path):
    """The counterpart of `repro`'s CLI test: a failure injected at step 3
    (checkpoints every 2) exits 42; the re-run resumes from step 2 and
    ends with ``done:``."""
    args = ["repro_torch.launch.train", "--arch", "tinyllama-1.1b", "--reduced", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu"]
    r = _run_cli(args + ["--inject-failure-at", "3"])
    assert r.returncode == 42, (r.returncode, r.stderr[-1500:])
    assert "simulated failure" in r.stdout
    r2 = _run_cli(args)
    assert r2.returncode == 0, r2.stderr[-1500:]
    assert "done: loss" in r2.stdout
    init = [json.loads(line) for line in r2.stdout.splitlines() if line.startswith('{"tag": "init"')]
    assert init[0]["resumed"] is True and init[0]["step"] == 2
    assert latest_step(str(tmp_path)) == 4


def test_train_cli_in_process_matches_trainer(tmp_path):
    """`main` returns its Trainer; its losses are those of a Trainer built
    by hand with the CLI's settings, and it refuses a missing CUDA
    device by default."""
    trainer = train_cli.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--ckpt-dir", str(tmp_path / "a"), "--device",
                              "cpu", "--seed", "3"])
    cfg = registry.get_config("rwkv6-3b").reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, batch_per_host=2, seed=3, v_eff=min(cfg.vocab, 512))
    ref = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2, total_steps=3), data,
                  ckpt_dir=str(tmp_path / "b"), ckpt_every=25,
                  logger=MetricLogger(stream=io.StringIO()), device="cpu").init_or_resume(3)
    ref_hist = ref.run(3)
    assert trainer.step == 3
    got = _state_arrays(trainer.state)
    for k, v in _state_arrays(ref.state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert np.isfinite(ref_hist).all()
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
                            "--ckpt-dir", str(tmp_path / "c")])


# --------------------------------------------------------------------------
# serving from a trainer checkpoint
# --------------------------------------------------------------------------
def test_serve_cli_restores_only_the_params_of_a_trainer_checkpoint(tmp_path, monkeypatch,
                                                                     capsys):
    """``launch/serve.py --ckpt-dir`` on a trainer checkpoint reads only its
    ``params/`` leaves (the masters and moments are never loaded onto the
    device) and serves the greedy tokens of an `Engine` on the trainer's
    in-memory parameters."""
    ckpt = str(tmp_path)
    trainer = train_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
                              "--ckpt-every", "2", "--device", "cpu"])
    loaded = []
    real = load_checkpoint_tensors

    def spy(*args, **kw):
        out = real(*args, **kw)
        loaded.extend(out)
        return out

    monkeypatch.setattr(serve_cli, "load_checkpoint_tensors", spy)
    res = serve_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--ckpt-dir", ckpt,
                          "--batch", "2", "--prompt-len", "8", "--max-new", "5",
                          "--device", "cpu"])
    assert "restored params from step 2" in capsys.readouterr().out
    assert loaded and all(k.startswith("params/") for k in loaded)
    assert len(loaded) == len(_flat(lm_params_to_numpy(trainer.state["params"])))
    cfg = trainer.cfg
    gen = torch.Generator().manual_seed(0)
    init_lm(cfg, gen, "cpu")                     # the CLI's draws before the prompts
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=gen, dtype=torch.int32)
    want = Engine(cfg, trainer.state["params"],
                  s_max=cache_rows(cfg, 8, 5) + 1).generate(prompts, max_new=5)
    assert torch.equal(res.tokens, want.tokens)


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------
def test_tree_utils_and_seed_derivation():
    tree = {"b": [torch.ones(2, 3), torch.zeros(4, dtype=torch.bfloat16)],
            "a": torch.full((5,), 2.0)}
    assert tree_param_count(tree) == 15
    assert tree_bytes(tree) == 6 * 4 + 4 * 2 + 5 * 4
    assert float(tree_global_norm(tree)) == pytest.approx(np.sqrt(6 + 20))
    _, cfg = _configs("tinyllama-1.1b")
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_param_count(model) == sum(p.numel() for p in model.parameters())
    assert fold_in_str(0, "data") == fold_in_str(0, "data")
    assert len({fold_in_str(0, "data"), fold_in_str(1, "data"), fold_in_str(0, "init")}) == 3
    assert 0 <= fold_in_str(7, "x") < 2 ** 63
    buf = io.StringIO()
    rec = MetricLogger(stream=buf).log("step", loss=1.5)
    assert json.loads(buf.getvalue())["loss"] == 1.5 and rec["tag"] == "step"
