"""Carry `repro`'s LM parameters across into the port.

`repro` keeps an LM's parameters as a nested dict whose block leaves carry
a stacked ``[L, ...]`` layer axis (built with ``jax.vmap``) and whose dense
weights are ``[d_in, d_out]``. `lm_params_from_numpy` takes that tree with
numpy leaves (``jax.device_get(params)``) or tensor leaves (a checkpoint
read by `repro_torch.checkpoint`), of a dense, MoE or VLM decoder (GQA or
MLA attention; an MoE's leading dense layers in ``dense_blocks``, its
expert weights as raw ``[L, E, ...]`` arrays; a parallel block's layers
without ``ln2``), of an RWKV6 model, of the Mamba2 hybrid (``lora``
[G, ...], ``mamba`` [G, M, ...] with two stacked axes, ``trailing``
[T, ...]) or of the Whisper encoder-decoder (``enc_blocks`` and
``dec_blocks``, each stacked, biased ``attn`` / ``self`` / ``cross`` and
``mlp`` leaves, ``dec_pos``), and returns the port's `Decoder`, `RWKV`,
`Zamba` or `Whisper`, which computes what `repro` computes from them.

The other way, `lm_params_to_tree` takes the port's model (or a mapping of
its parameter names to tensors, such as their gradients or an optimizer's
moments) and stacks it back into `repro`'s tree, tensor leaves;
`lm_params_to_numpy` gives the same tree with numpy leaves. The trainer's
checkpoints are written in that layout, and `tree_to_named` splits such a
tree back onto parameter names.
"""
from __future__ import annotations

import itertools
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.device_graph import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import Dense, Embed, Norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mla import MLA
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rwkv6 import ChannelMix, TimeMix
from repro_torch.models.rwkv_model import RWKV, RWKVBlock
from repro_torch.models.ssm import Mamba2
from repro_torch.models.transformer import Block, Decoder, check_family
from repro_torch.models.whisper import DecBlock, EncBlock, Whisper
from repro_torch.models.zamba import LoRA, LoRASet, MambaBlock, SharedBlock, Zamba


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``. bf16 arrays (``ml_dtypes``, which
    `torch.from_numpy` refuses) go through a uint16 view of their bits; a
    tensor (a checkpoint leaf the store already rebuilt) is moved as it
    is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


# subtrees with stacked layer axes, and how many (the hybrid's Mamba2
# layers are [G, M, ...])
STACKS = {"blocks": 1, "dense_blocks": 1, "lora": 1, "trailing": 1, "mamba": 2,
          "enc_blocks": 1, "dec_blocks": 1}


def _leaves(tree: dict) -> list:
    return [a for v in tree.values() for a in (_leaves(v) if isinstance(v, dict) else [v])]


def _paths(tree: dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        out |= _paths(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k}
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: dict,
                         device) -> Decoder | RWKV | Zamba | Whisper:
    """The port's `Decoder` (dense, moe and vlm families), `RWKV` (``ssm``
    family), `Zamba` (``hybrid`` family) or `Whisper` (``encdec`` family)
    on ``device`` from `repro`'s parameter tree with numpy leaves.
    Raises if the tree holds leaves the port would not use (or lacks some),
    or a stack with another number of layers than ``cfg`` gives it."""
    dev = resolve_device(device)

    def put(a):
        return tensor_from_numpy(a, dev)

    def norm(d, bias=False):
        """A norm ({g, b}); ``bias`` requires its b."""
        return Norm(put(d["g"]), put(d["b"]) if bias or "b" in d else None)

    def lin(d, bias=False):
        """A dense layer ({w, b}); ``bias`` requires its b."""
        return Dense(put(d["w"]), put(d["b"]) if bias or "b" in d else None)

    def layer(d, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in d.items()}

    def module(d, cls):
        """``cls`` from a dict of arrays, dense layers ({w}) and norms ({g, b})."""
        try:
            return cls(**{k: (lin(v) if "w" in v else norm(v)) if isinstance(v, dict)
                          else put(v) for k, v in d.items()})
        except TypeError as e:      # a key too many or too few
            raise ValueError(f"parameter tree does not match {cfg.name}: {e}") from e

    def fail(what):
        raise ValueError(f"parameter tree does not match {cfg.name}: {what}")

    def split(sub, n, what):
        """The n layers of a subtree stacked along its leading axis."""
        lens = {int(a.shape[0]) for a in _leaves(sub)}
        if lens != {n}:
            fail(f"{what} holds {sorted(lens)} layers, expected {n}")
        return [layer(sub, i) for i in range(n)]

    def stack(name, n):
        """The n layers of the stacked subtree ``tree[name]``."""
        if name not in tree:
            fail(f"no {name}")
        return split(tree[name], n, name)

    def mlp(d, kind, bias=False):
        names = ("w_gate", "w_up", "w_down") if kind == "swiglu" else ("w_up", "w_down")
        if set(d) != set(names):
            fail(f"a {kind} mlp holds {sorted(d)}, expected {sorted(names)}")
        return MLP(kind, **{n: lin(d[n], bias) for n in names})

    def attention(d):
        if cfg.attn_kind != "mla":
            return Attention(*(lin(d[n]) for n in ("wq", "wk", "wv", "wo")))
        if ("wq" in d) == bool(cfg.q_lora_rank):
            fail(f"q_lora_rank {cfg.q_lora_rank} but attn holds {sorted(d)}")
        return module(d, MLA)

    def block(bt, moe_layer):
        if moe_layer != ("moe" in bt):
            fail(f"expected {'moe' if moe_layer else 'mlp'}, got {sorted(bt)}")
        if not moe_layer:
            ffn = {"mlp": mlp(bt["mlp"], cfg.mlp_kind)}
        else:
            m = bt["moe"]
            if ("shared" in m) != bool(cfg.n_shared_experts):
                fail(f"n_shared_experts {cfg.n_shared_experts} but moe holds {sorted(m)}")
            shared = mlp(m["shared"], "swiglu") if "shared" in m else None
            ffn = {"moe": MoE(lin(m["router"]), put(m["w_gate"]), put(m["w_up"]),
                              put(m["w_down"]), shared)}
        # a parallel block has no ln2 (an ln2 in its tree is a leaf too many)
        ln2 = None if cfg.parallel_block else norm(bt["ln2"])
        return Block(norm(bt["ln1"]), attention(bt["attn"]), ln2, **ffn)

    def biased_attention(d):        # Whisper's: every projection has a bias
        return Attention(*(lin(d[n], bias=True) for n in ("wq", "wk", "wv", "wo")))

    def mamba_block(bt):
        return MambaBlock(norm(bt["ln"]), module(bt["mix"], Mamba2))

    embed = Embed(put(tree["embed"]["emb"]))
    if cfg.family == "encdec":
        try:
            enc = [EncBlock(norm(bt["ln1"], True), biased_attention(bt["attn"]),
                            norm(bt["ln2"], True), mlp(bt["mlp"], "gelu", bias=True))
                   for bt in stack("enc_blocks", cfg.n_enc_layers)]
            dec = [DecBlock(norm(bt["ln1"], True), biased_attention(bt["self"]),
                            norm(bt["ln2"], True), biased_attention(bt["cross"]),
                            norm(bt["ln3"], True), mlp(bt["mlp"], "gelu", bias=True))
                   for bt in stack("dec_blocks", cfg.n_layers)]
            model = Whisper(embed, put(tree["dec_pos"]), enc, norm(tree["enc_ln"], True), dec,
                            norm(tree["dec_ln"], True))
        except KeyError as e:
            fail(f"no {e}")
    elif cfg.family == "hybrid":
        g, m, t = cfg.n_attn_groups, cfg.mamba_per_group, cfg.trailing_mamba
        try:
            sh = tree["shared"]
            shared = SharedBlock(norm(sh["ln1"]), attention(sh["attn"]), norm(sh["ln2"]),
                                 mlp(sh["mlp"], "swiglu"),
                                 lin(sh["out"]))
            lora = [LoRASet(*(LoRA(put(lt[n]["a"]), put(lt[n]["b"])) for n in "qkv"))
                    for lt in stack("lora", g)]
            mamba = [[mamba_block(bt) for bt in split(grp, m, f"mamba group {gi}")]
                     for gi, grp in enumerate(stack("mamba", g))]
            trailing = [mamba_block(bt) for bt in stack("trailing", t)] if t else []
        except KeyError as e:
            fail(f"no {e}")
        model = Zamba(embed, shared, lora, mamba, trailing, norm(tree["ln_f"]),
                      Embed(put(tree["unembed"]["emb"])))
    elif cfg.family == "ssm":
        try:
            blocks = [RWKVBlock(norm(bt["ln1"]), norm(bt["ln2"]), module(bt["time"], TimeMix),
                                module(bt["chan"], ChannelMix))
                      for bt in stack("blocks", cfg.n_layers)]
            model = RWKV(embed, norm(tree["ln0"]), blocks, norm(tree["ln_f"]),
                         Embed(put(tree["unembed"]["emb"])))
        except KeyError as e:
            fail(f"no {e}")
    else:
        check_family(cfg)
        n_dense = cfg.first_dense if cfg.moe else 0
        try:
            blocks = [block(bt, cfg.moe) for bt in stack("blocks", cfg.n_layers - n_dense)]
            dense_blocks = ([block(bt, False) for bt in stack("dense_blocks", n_dense)]
                            if n_dense else [])
        except KeyError as e:
            fail(f"no {e}")
        unembed = None if cfg.tie_embeddings else Embed(put(tree["unembed"]["emb"]))
        model = Decoder(embed, blocks, norm(tree["ln_f"]), unembed, dense_blocks)

    # every leaf of the tree is a parameter of the model, and back
    used = {".".join(p for j, p in enumerate(name.split("."))
                     if not 1 <= j <= STACKS.get(name.split(".")[0], 0))
            for name, _ in model.named_parameters()}
    if used != _paths(tree):
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"unused {sorted(_paths(tree) - used)}, "
                         f"missing {sorted(used - _paths(tree))}")
    return model


def param_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A port parameter name -> (its leaf's path in `repro`'s tree, its
    indices along that leaf's stacked layer axes): ``blocks.3.attn.wq.w``
    -> ((blocks, attn, wq, w), (3,)), ``mamba.1.0.ln.g`` -> ((mamba, ln,
    g), (1, 0)), ``embed.emb`` -> ((embed, emb), ())."""
    parts = name.split(".")
    n = STACKS.get(parts[0], 0)
    return (parts[0],) + tuple(parts[1 + n:]), tuple(int(i) for i in parts[1:1 + n])


def _named(src) -> dict:
    if isinstance(src, nn.Module):
        return {name: p.detach() for name, p in src.named_parameters()}
    return {name: t.detach() for name, t in src.items()}


def lm_params_to_tree(src: nn.Module | Mapping[str, torch.Tensor], device=None) -> dict:
    """`repro`'s parameter tree from the port's model ``src`` (or a mapping
    of its parameter names to tensors of the parameters' shapes): the
    layer axes stacked (``mamba`` [G, M, ...]), dense weights [d_in,
    d_out], every family's layout as `lm_params_from_numpy` reads it.
    Leaves are tensors on ``device`` (default: where ``src``'s are);
    stacked leaves are new tensors, the others ``src``'s own (detached)."""
    groups: dict = {}
    for name, t in _named(src).items():
        path, idx = param_path(name)
        groups.setdefault(path, {})[idx] = t if device is None else t.to(device)
    tree: dict = {}
    for path, items in groups.items():
        dims = [1 + max(i[a] for i in items) for a in range(len(next(iter(items))))]
        if set(items) != set(itertools.product(*map(range, dims))):
            raise ValueError(f"{'.'.join(path)}: layers {sorted(items)} are not a full stack")

        def stacked(prefix: tuple, items=items, dims=dims):
            if len(prefix) == len(dims):
                return items[prefix]
            return torch.stack([stacked(prefix + (j,)) for j in range(dims[len(prefix)])])

        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stacked(())
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                   # bf16 numpy arrays, as `repro` holds them
        return t.view(torch.uint16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def lm_params_to_numpy(src: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """`lm_params_to_tree` with numpy leaves (copies; bf16 leaves as
    ``ml_dtypes.bfloat16``, which must then be importable): the inverse of
    `lm_params_from_numpy`, and what `repro`'s functions take."""
    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _to_numpy(v) for k, v in node.items()}
    return walk(lm_params_to_tree(src, device="cpu"))


def tree_to_named(names, tree: dict) -> dict:
    """``{name: tensor}`` for each parameter name in ``names`` (a model's
    `named_parameters` names, or the model itself) from `repro`'s tree:
    the leaf at the name's path, indexed along its stacked axes (views)."""
    if isinstance(names, nn.Module):
        names = [name for name, _ in names.named_parameters()]
    out = {}
    for name in names:
        path, idx = param_path(name)
        node = tree
        try:
            for key in path:
                node = node[key]
        except KeyError as e:
            raise KeyError(f"tree holds no {'/'.join(path)} for {name}") from e
        out[name] = node[idx] if idx else node
    return out
