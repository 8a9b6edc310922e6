"""The port's LM plane vs the reference's, on the CPU at f32.

The same numpy inputs, and the reference's parameters carried across with
``load_jax_params``, go through ``repro.models`` (JAX) and
``repro_torch.models`` (``device="cpu"``, so attention's ``pallas`` impl
runs the flash kernel's plain version). Bar: 1e-5 abs and rel unless a test
says otherwise; both sides compute in f32 and differ only in the order of
their sums.

On the CPU the reference's ``Model.forward`` with ``attn_impl="pallas"``
resolves to its XLA oracle (``kernels/flash_attention/ops.py``); the
interpret-mode Pallas kernel is held against the port in
tests/test_torch_flash_attention.py.
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get as ref_get
from repro.models import Model as RefModel
from repro.models.layers import attention as ref_att
from repro.models.layers import mlp as ref_mlp
from repro.models.layers import norms as ref_norms
from repro.models.layers import rope as ref_rope
from repro_torch.configs import get
from repro_torch.models import Model, load_jax_params
from repro_torch.models.common import dense_init
from repro_torch.models.layers import attention, mlp, norms, rope

TOL = 1e-5
S = 40  # > attn_chunk 16 of the reduced configs: the pallas / chunked paths run
ARCHS = ["hubert-xlarge", "minitron-4b", "starcoder2-15b", "qwen1.5-32b", "recurrentgemma-9b"]
MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b", "mixtral-8x22b-mwu", "dbrx-132b-mwu"]


def _hubert_cut(get_fn):
    """hubert-xlarge at its real d_head 80 and MHA, cut to 2 layers of width 160."""
    return replace(get_fn("hubert-xlarge"), name="hubert-xlarge-cut", n_layers=2, d_model=160, n_heads=2,
                   n_kv_heads=2, d_head=80, d_ff=640, attn_chunk=16, dtype="float32", param_dtype="float32",
                   remat="none", attn_impl="pallas")


def _rg_cut(get_fn):
    """recurrentgemma-9b at its real d_head 256 and MQA (2 query heads over 1 kv head), cut to 5 layers of
    width 128: one repetition of (rglru, rglru, attn) and the (rglru, rglru) tail, the 38-layer layout in
    small."""
    return replace(get_fn("recurrentgemma-9b"), name="rg-cut", n_layers=5, d_model=128, n_heads=2, n_kv_heads=1,
                   d_head=256, d_ff=256, vocab_size=256, rnn_width=128, sliding_window=16, attn_chunk=16,
                   dtype="float32", param_dtype="float32", remat="none", attn_impl="pallas")


_CUTS = {"hubert-cut": _hubert_cut, "rg-cut": _rg_cut}


def _cfgs(name, impl="pallas"):
    """(reference config, port config) of one test case."""
    if name in _CUTS:
        cut = _CUTS[name]
        return replace(cut(ref_get), attn_impl=impl), replace(cut(get), attn_impl=impl)
    return replace(ref_get(name).reduced(), attn_impl=impl), replace(get(name).reduced(), attn_impl=impl)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got: torch.Tensor, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCH_IDS + ["dbrx-132b-mwu", "mixtral-8x22b-mwu"])
def test_configs_same_numbers(arch):
    assert asdict(get(arch)) == asdict(ref_get(arch))
    assert asdict(get(arch).reduced()) == asdict(ref_get(arch).reduced())
    assert get(arch).padded_vocab == ref_get(arch).padded_vocab
    assert get(arch).n_params() == ref_get(arch).n_params()


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms(norm_type):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32), "bias": rng.standard_normal(48).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    ref = ref_norms.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), norm_type, 1e-6)
    got = norms.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), norm_type, 1e-6)
    _close(got, ref)


@pytest.mark.parametrize("pos_shape", ["(S,)", "(B,S)"])
@pytest.mark.parametrize("d_head", [32, 80])
def test_rope(pos_shape, d_head):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, d_head)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    if pos_shape == "(B,S)":
        pos = np.stack([pos, pos + 100])
    ref = ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = rope.apply_rope(_t(x), _t(pos), 10_000.0)
    _close(got, ref, tol=1e-4)  # angles up to ~108 rad: f32 sin/cos of two libraries


@pytest.mark.parametrize("arch", ["minitron-4b", "starcoder2-15b"])  # swiglu, gelu (tanh)
def test_mlp(arch):
    rcfg, cfg = _cfgs(arch)
    params = _np_tree(ref_mlp.mlp_init(jax.random.PRNGKey(0), rcfg, jnp.float32))
    params = {k: v + 0.1 if k.startswith("b") else v for k, v in params.items()}  # nonzero biases
    x = np.random.default_rng(2).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    ref = ref_mlp.mlp_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), rcfg)
    got = mlp.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    _close(got, ref)


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS + ["hubert-cut", "rg-cut"])
def test_attention_apply(arch, impl):
    rcfg, cfg = _cfgs(arch, impl)
    params = _np_tree(ref_att.attention_init(jax.random.PRNGKey(1), rcfg, jnp.float32))
    params = {k: v + 0.05 if k.startswith("b") else v for k, v in params.items()}  # nonzero qkv bias
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    ref, _ = ref_att.attention_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), rcfg,
                                     positions=jnp.asarray(pos), impl=impl)
    got, cache = attention.attention_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg, positions=_t(pos),
                                           impl=impl)
    assert cache is None
    _close(got, ref)


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b", "rg-cut"])
def test_attention_with_cache(arch):
    """A prompt of S 40 into an empty cache of 64 positions, then one
    decode step, against the reference's attention_apply with its KVCache:
    the outputs, and the caches' K, V and slot positions (a ring of 16
    slots for a window of 16: the last 16 positions)."""
    rcfg, cfg = _cfgs(arch)
    params = _np_tree(ref_att.attention_init(jax.random.PRNGKey(1), rcfg, jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, S + 1, cfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: _t(v) for k, v in params.items()}
    ref_cache = ref_att.init_kv_cache(rcfg, 2, 64, jnp.float32)
    cache = attention.init_kv_cache(cfg, 2, 64, torch.float32, "cpu")
    for lo, hi in ((0, S), (S, S + 1)):
        pos = np.arange(lo, hi, dtype=np.int32)
        ref, ref_cache = ref_att.attention_apply(rp, jnp.asarray(x[:, lo:hi]), rcfg, positions=jnp.asarray(pos),
                                                 cache=ref_cache)
        got, cache = attention.attention_apply(p, _t(x[:, lo:hi]), cfg, cache=cache, start=lo)
        _close(got, ref)
        for name in ("k", "v"):
            _close(getattr(cache, name), getattr(ref_cache, name))
        np.testing.assert_array_equal(cache.slot_pos.numpy(), np.asarray(ref_cache.slot_pos))
    assert int(cache.slot_pos.max()) == S and cache.k.shape[1] == (16 if cfg.sliding_window else 64)


def _batch(cfg, B=2):
    rng = np.random.default_rng(4)
    if cfg.modality == "audio_frames":  # N(0, 0.02^2) frames, as configs/shapes.py makes them
        return {"frames": (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS + ["hubert-cut", "rg-cut"] + MOE_ARCHS)
def test_model_forward_logits(arch):
    """Model.forward + logits with the reference's parameters, attn_impl pallas."""
    rcfg, cfg = _cfgs(arch)
    ref_model = RefModel(rcfg, fsdp=False)
    params = ref_model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    ref = ref_model.logits(params, ref_model.forward(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = load_jax_params(Model(cfg, device="cpu"), _np_tree(params))
    with torch.inference_mode():
        got = model.logits(model({k: _t(v) for k, v in batch.items()}))
    assert got.shape == (2, S, cfg.padded_vocab) and got.dtype == torch.float32
    ref = np.asarray(ref)
    V = cfg.vocab_size
    np.testing.assert_array_equal(got[..., V:].numpy(), ref[..., V:])  # the pad-vocab mask
    scale = np.abs(ref[..., :V]).max()
    np.testing.assert_allclose(got[..., :V].numpy() / scale, ref[..., :V] / scale, atol=TOL)


def test_load_jax_params_unstacks_layers_in_order():
    """Layer r*k + j of the port holds repetition r of pattern position j."""
    rcfg, cfg = _cfgs("minitron-4b")
    cfg, rcfg = replace(cfg, n_layers=3), replace(rcfg, n_layers=3)
    params = _np_tree(RefModel(rcfg, fsdp=False).init(jax.random.PRNGKey(5)))
    model = load_jax_params(Model(cfg, device="cpu"), params)
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.attn["wq"].detach().numpy(), params["blocks"]["b0"]["attn"]["wq"][i])
    np.testing.assert_array_equal(model.embedding.detach().numpy(), params["embed"])
    params["lm_head"] = params["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        load_jax_params(model, params)


def test_load_jax_params_rglru_layers():
    """rg-cut's layers by kind: 0, 1, 3 and 4 (the tail) are rglru blocks, 2 the attn block; each holds the
    reference's leaves, the stacked ones at their repetition and the tail's as they are."""
    rcfg, cfg = _cfgs("rg-cut")
    params = _np_tree(RefModel(rcfg, fsdp=False).init(jax.random.PRNGKey(6)))
    model = load_jax_params(Model(cfg, device="cpu"), params)
    assert [blk.kind for blk in model.blocks] == ["rglru", "rglru", "attn", "rglru", "rglru"]
    layers = [params["blocks"]["b0"], params["blocks"]["b1"], params["blocks"]["b2"],
              params["tail"]["t0"], params["tail"]["t1"]]
    for i, (blk, layer) in enumerate(zip(model.blocks, layers)):
        groups = ("ln1", blk.kind, "ln2", "mlp")
        assert set(layer) == set(groups)
        for grp in groups:
            for name, leaf in layer[grp].items():
                ref = leaf[0] if i < 3 else leaf  # one repetition of the stacked pattern unit
                np.testing.assert_array_equal(getattr(blk, grp)[name].detach().numpy(), ref, err_msg=f"layer {i} {grp}.{name}")
    # attn groups where the model has an rglru block
    params["tail"]["t1"] = jax.tree.map(lambda a: a[0], params["blocks"]["b2"])
    with pytest.raises(ValueError, match="layer 4"):
        load_jax_params(model, params)


@pytest.mark.parametrize("arch", ["mixtral-8x22b-mwu", "dbrx-132b"])
def test_load_jax_params_moe_layers(arch):
    """An MoE config with a tail: three attn layers as one repetition of
    (attn, attn) and one tail layer. Every layer's ``moe`` group holds the
    reference's router, wg, wu and wd (stacked at their repetition, the
    tail's as they are), and its block applies the MoE layer: the tail
    block against the reference's Model._apply_block."""
    from repro.models.model import Model as RefModelCls

    rcfg, cfg = (replace(c, n_layers=3, block_pattern=("attn", "attn")) for c in _cfgs(arch))
    params = _np_tree(RefModel(rcfg, fsdp=False).init(jax.random.PRNGKey(9)))
    model = load_jax_params(Model(cfg, device="cpu"), params)
    layers = [params["blocks"]["b0"], params["blocks"]["b1"], params["tail"]["t0"]]
    for i, (blk, layer) in enumerate(zip(model.blocks, layers)):
        assert blk.groups == ("ln1", "attn", "ln2", "moe") and not hasattr(blk, "mlp")
        assert set(layer["moe"]) == {"router", "wg", "wu", "wd"}
        for name, leaf in layer["moe"].items():
            ref = leaf[0] if i < 2 else leaf
            np.testing.assert_array_equal(blk.moe[name].detach().numpy(), ref, err_msg=f"layer {i} moe.{name}")
    x = np.random.default_rng(10).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ref, _ = RefModelCls(rcfg, fsdp=False)._apply_block("attn", jax.tree.map(jnp.asarray, layers[2]), jnp.asarray(x),
                                                        jnp.arange(S))
    with torch.no_grad():  # attn_impl "pallas": the flash kernel is forward-only
        got, cache = model._apply_block(model.blocks[2], _t(x), torch.arange(S))
    assert cache is None
    _close(got, ref, tol=2e-4)  # tests/test_layers.py:172
    # an mlp group where the model has an moe block
    params["tail"]["t0"]["mlp"] = params["tail"]["t0"].pop("moe")
    with pytest.raises(ValueError, match="layer 2"):
        load_jax_params(model, params)


def test_rglru_block_forward():
    """One rglru layer of the model (ln1, rglru, residual, ln2, mlp, residual) against the reference's
    Model._apply_block, rg-cut's widths."""
    from repro.models.model import Model as RefModelCls

    rcfg, cfg = _cfgs("rg-cut")
    params = _np_tree(RefModel(rcfg, fsdp=False).init(jax.random.PRNGKey(7)))
    layer = params["tail"]["t0"]
    x = np.random.default_rng(8).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ref, _ = RefModelCls(rcfg, fsdp=False)._apply_block("rglru", jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
                                                        jnp.arange(S))
    model = load_jax_params(Model(cfg, device="cpu"), params)
    got, state = model._apply_block(model.blocks[3], _t(x), torch.arange(S))
    assert state is None
    _close(got, ref)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "internvl2-26b"])
def test_model_unported_kinds_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get(arch).reduced(), device="cpu")


def test_model_random_init():
    """Seeded init: the same seed gives the same weights; each weight is a
    normal cut at +-2 std with std = scale / sqrt(fan_in)."""
    _, cfg = _cfgs("hubert-cut")
    a, b = Model(cfg, device="cpu", seed=3), Model(cfg, device="cpu", seed=3)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, (400, 300), torch.float32, "cpu", scale=2.0)
    std = 2.0 / 20.0
    assert w.abs().max() <= 2 * std
    assert abs(float(w.std()) / std - 0.8796) < 0.01  # std of N(0, 1) cut at +-2
