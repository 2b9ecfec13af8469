"""The port's examples run on the CPU at their smoke sizes: the
partitioner quickstart, LM serving across three families, and training
with an injected failure and its resume (each `main(argv)` in process)."""
import importlib.util
import os

import pytest

pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _main(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("name,argv,expect", [
    ("quickstart_torch", ["--scale", "0.0005", "--max-steps", "10"],
     ["revolver", "spinner", "restream", "hash", "range"]),
    ("serve_lm_torch", ["--max-new", "4"], ["tinyllama-1.1b", "rwkv6-3b", "deepseek-v2-lite-16b"]),
    ("train_lm_torch", ["--smoke", "--steps", "4", "--fail-at", "2"],
     ["injected at step 2", "loss: first="]),
])
def test_example_runs_on_the_cpu(name, argv, expect, capsys, tmp_path):
    if name == "train_lm_torch":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    _main(name)(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for word in expect:
        assert word in out, (word, out)
