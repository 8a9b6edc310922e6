"""The port's training path vs ``repro.train`` / ``repro.data`` /
``repro.configs.shapes``, on the CPU.

The same numpy inputs, and the reference's parameters carried across with
``load_jax_params``, go through the reference (JAX, x64 on as
tests/conftest.py sets it) and the port (``device="cpu"``). The reduced
configs compute in f32.

Bars:
  * loss: rel 1e-5 (both sides f32, sums in another order);
  * gradients: every entry within GRAD_TOL = 1e-5 of its tensor's largest
    |reference entry| (measured on these configs: at most 1.7e-6, hubert's
    wk; the reference differentiates the same f32 forward in another order);
  * ``adamw_update`` on the reference's own gradients: moments within 1e-6
    relative plus 1e-6 of the tensor's largest entry (both f32; the clip
    scale comes from a norm summed in another order, and b m + (1 - b) g
    can cancel, so its ulp is the terms', measured at 5.9e-6 relative on an
    entry of 1.5e-7), parameters within 2 ulp of f32 at |p| plus 1e-9 (the
    reference under x64 takes the learning rate in f64, the port in f32).
The whole step is compared through its parts (loss, gradients, update)
rather than its result: the first AdamW step is about lr * sign(g), so a
gradient entry near 0 that the two frameworks round to opposite signs
moves a parameter 2 lr apart; ``test_train_step_update_matches_reference``
bounds that case explicitly.
The ``-mwu`` configs route by the port's router and hand its routes to the
reference's layer (a host callback), as
tests/test_torch_moe.py::test_moe_apply_mwu_matches_reference_given_routes
does: the f32 routing LP is decided by rounding (that file's docstring).
"""
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get as ref_get
from repro.configs import shapes as ref_shapes
from repro.data.synthetic import TokenPipeline as RefPipeline
from repro.models import Model as RefModel
from repro.models.layers import moe as ref_moe
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import get, shapes
from repro_torch.data import TokenPipeline
from repro_torch.models import Model, load_jax_params
from repro_torch.models.layers import moe
from repro_torch.models.model import _by_name
from repro_torch.train import (AdamWConfig, OptState, adamw_update, chunked_ce_loss, init_opt_state,
                               load_jax_train_state, lr_at, make_train_state, make_train_step)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-6
ULP2 = 2 * float(np.finfo(np.float32).eps)
NOT_PORTED = ["mamba2-1.3b", "internvl2-26b"]  # ROADMAP queue 1 item 15.3
TRAIN_ARCHS = [a for a in ARCH_IDS if a not in NOT_PORTED] + ["mixtral-8x22b-mwu", "dbrx-132b-mwu"]
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def tiny_batch(cfg, B=2, S=32, seed=0) -> dict:
    """tests/test_substrate.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.modality == "audio_frames":
        batch["frames"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch["loss_mask"] = np.ones((B, S), np.float32)
    return batch


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(arch, seed=0, **kw):
    """(reference model, its params as numpy, the port's model holding them)."""
    rcfg, cfg = replace(ref_get(arch).reduced(), **kw), replace(get(arch).reduced(), **kw)
    rm = RefModel(rcfg, fsdp=False)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed)))
    return rm, params, load_jax_params(Model(cfg, device="cpu"), params)


class _GivenRoutes:
    """The port's mwu router, recorded; the reference's router replaced by a
    host callback that returns the port's routes for the same logits (1e-5)
    and gates from the reference's own probs, so its gates differentiate."""

    def __init__(self, monkeypatch):
        self.seen = []
        route = moe.mwu_route

        def recording(logits, k, capacity, mwu_iters=16):
            idx, gate = route(logits, k, capacity, mwu_iters)
            self.seen.append((logits.detach().numpy().copy(), idx.numpy()))
            return idx, gate

        def port_routes(lg):
            lg = np.asarray(lg)
            hits = [idx for seen, idx in self.seen if seen.shape == lg.shape and np.allclose(seen, lg, atol=1e-5)]
            assert hits, "the reference's router saw logits the port's did not"
            return hits[0].astype(np.int32)

        def given(lg, k, capacity, mwu_iters=16):
            idx = jax.pure_callback(port_routes, jax.ShapeDtypeStruct(lg.shape[:-1] + (k,), jnp.int32),
                                    jax.lax.stop_gradient(lg), vmap_method="expand_dims")
            probs = jax.nn.softmax(lg.astype(jnp.float32), axis=-1)
            gate = jnp.take_along_axis(probs, idx, axis=-1)
            return idx, (gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)).astype(lg.dtype)

        monkeypatch.setattr(moe, "mwu_route", recording)
        monkeypatch.setattr(ref_moe, "mwu_route", given)


def _ref_loss_and_grads(rm, params, batch, chunk=512):
    loss, grads = jax.value_and_grad(lambda p: ref_step.chunked_ce_loss(rm, p, _j(batch), chunk=chunk))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def _assert_grads_close(model, ref_grads):
    """Every parameter's gradient within GRAD_TOL of its tensor's largest
    |reference entry|; None (a parameter the loss does not reach) as 0."""
    want = _by_name(model, ref_grads)
    for name, p in model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(got, want[name], atol=GRAD_TOL * scale, rtol=0, err_msg=name)


def test_new_modules_import_without_jax():
    """The training modules import neither jax nor repro; a Trainer step runs."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.train, repro_torch.checkpoint.ckpt, repro_torch.data, repro_torch.configs.shapes\n"
        "from repro_torch.configs import get\n"
        "from repro_torch.train import Trainer, TrainerConfig\n"
        "t = Trainer(get('minitron-4b').reduced(), TrainerConfig(steps=1, seq_len=16, global_batch=2, log_every=1),"
        " device='cpu')\n"
        "t.run()\n"
        "assert t.final_state.step == 1\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("seed, step", [(0, 0), (5, 17), (3, 1000)])
def test_token_pipeline_equals_reference(seed, step):
    ours, ref = TokenPipeline(1000, 48, 4, seed=seed).batch_at(step), RefPipeline(1000, 48, 4, seed=seed).batch_at(step)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_cells_match_reference(arch):
    """SHAPES, skip_reason and input_specs as the reference's; concrete_inputs
    the reference's numbers."""
    cfg, rcfg = get(arch), ref_get(arch)
    assert {k: vars(c) for k, c in shapes.SHAPES.items()} == {k: vars(c) for k, c in ref_shapes.SHAPES.items()}
    for name, cell in shapes.SHAPES.items():
        rcell = ref_shapes.SHAPES[name]
        assert shapes.skip_reason(cfg, cell) == ref_shapes.skip_reason(rcfg, rcell)
        assert [c.name for c in shapes.cells_for(cfg)] == [c.name for c in ref_shapes.cells_for(rcfg)]
        spec, rspec = shapes.input_specs(cfg, cell), ref_shapes.input_specs(rcfg, rcell)
        assert list(spec) == list(rspec)
        for k, (shape, dtype) in spec.items():
            assert shape == rspec[k].shape and str(dtype).split(".")[-1] == str(rspec[k].dtype)
    cell = replace(shapes.SHAPES["train_4k"], seq_len=24, global_batch=2)
    rcell = replace(ref_shapes.SHAPES["train_4k"], seq_len=24, global_batch=2)
    small, rsmall = get(arch).reduced(), ref_get(arch).reduced()
    got = shapes.concrete_inputs(small, cell, seed=3, device="cpu")
    want = ref_shapes.concrete_inputs(rsmall, rcell, seed=3)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 120])
def test_lr_at_matches_reference(step):
    """f32 on both sides (the reference's step is an int32 array, as in its train step)."""
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    ref = ref_opt.lr_at(ref_opt.AdamWConfig(**vars(cfg)), jnp.asarray(step, jnp.int32))
    got = lr_at(cfg, step)
    assert got.dtype == np.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "minitron-4b", "mixtral-8x22b"])
def test_decay_rule_is_the_reference_leaf_rule(arch):
    """Stacked leaves (the first reps * k layers) are all decayed, 1-D ones
    too; the tail's and the top level's 1-D leaves are not. Configs with a
    tail: recurrentgemma's 5 layers over its 3-layer unit, the others with a
    2-layer unit over 3 layers."""
    kw = dict(n_layers=5) if arch == "recurrentgemma-9b" else dict(n_layers=3, block_pattern=("attn", "attn"))
    _, params, model = _pair(arch, **kw)
    assert model.reps * len(model.pattern_unit) < len(model.blocks)  # a tail exists
    rule = jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), params)
    want = {n: bool(a.all()) for n, a in _by_name(model, rule).items()}
    got = model.decayed()
    assert got == want
    tail_1d = [n for n, p in model.named_parameters() if p.dim() == 1 and n.startswith("blocks.")
               and int(n.split(".")[1]) >= model.reps * len(model.pattern_unit)]
    assert tail_1d and not any(got[n] for n in tail_1d)
    assert any(got[n] for n, p in model.named_parameters() if p.dim() == 1 and n.startswith("blocks.0."))
    # zero gradients: only weight decay moves a parameter, so exactly the decayed ones move
    state = make_train_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    adamw_update(OPT, {n: torch.zeros_like(p) for n, p in model.named_parameters()}, state.opt, state.params,
                 model.decayed())
    for n, p in model.named_parameters():
        assert (not torch.equal(p.detach(), before[n])) == (got[n] and bool(before[n].any())), n


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_loss_and_grads_match_reference(arch, monkeypatch):
    """One step of each ported reduced arch: the loss and every gradient
    against ``jax.value_and_grad`` of the reference's loss (module
    docstring's bars), then the step's metrics."""
    routes = _GivenRoutes(monkeypatch) if arch.endswith("-mwu") else None
    rm, params, model = _pair(arch)
    batch = tiny_batch(model.cfg)
    loss = chunked_ce_loss(model, _t(batch))
    loss.backward()
    ref_loss, ref_grads = _ref_loss_and_grads(rm, params, batch)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_TOL)
    _assert_grads_close(model, ref_grads)
    if routes is not None:
        assert len(routes.seen) == model.cfg.n_layers  # every layer routed by the LP
    state, m = make_train_step(model, OPT)(make_train_state(model), _t(batch))
    assert state.step == 1 and state.opt.count == 1
    np.testing.assert_allclose(float(m["loss"]), ref_loss, rtol=LOSS_TOL)
    assert np.isfinite(float(m["grad_norm"])) and float(m["lr"]) == float(lr_at(OPT, 0))
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_not_ported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(get(arch).reduced(), device="cpu")


def _ref_state_after(rm, params, batch, steps=1):
    """The reference's TrainState after ``steps`` of its own train step."""
    state = ref_step.TrainState(params=jax.tree.map(jnp.asarray, params),
                                opt=ref_opt.init_opt_state(params), step=jnp.zeros((), jnp.int32))
    fn = jax.jit(ref_step.make_train_step(rm, ref_opt.AdamWConfig(**vars(OPT))))
    for _ in range(steps):
        state, _ = fn(state, _j(batch))
    return state


@pytest.mark.parametrize("arch", ["minitron-4b", "recurrentgemma-9b", "dbrx-132b"])
def test_adamw_update_matches_reference_on_its_grads(arch):
    """The reference's state after one step (nonzero moments, count 1), the
    reference's gradients at it: ``adamw_update`` of both packages, moments
    and parameters compared by name (module docstring's bars)."""
    kw = dict(n_layers=5) if arch == "recurrentgemma-9b" else dict(n_layers=3, block_pattern=("attn", "attn"))
    rm, params, model = _pair(arch, **kw)
    batch = tiny_batch(model.cfg)
    rstate = _ref_state_after(rm, params, batch)
    _, grads = _ref_loss_and_grads(rm, jax.tree.map(np.asarray, rstate.params), batch)
    state = load_jax_train_state(model, jax.tree.map(np.asarray, rstate))
    rparams, ropt, rm_ = ref_opt.adamw_update(ref_opt.AdamWConfig(**vars(OPT)), jax.tree.map(jnp.asarray, grads),
                                              rstate.opt, rstate.params)
    own = {n: torch.from_numpy(np.array(a)) for n, a in _by_name(model, grads).items()}
    _, opt, m = adamw_update(OPT, own, state.opt, state.params, model.decayed())
    assert opt.count == int(ropt.count) == 2
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm_["grad_norm"]), rtol=MOMENT_TOL)
    np.testing.assert_allclose(m["lr"], float(rm_["lr"]), rtol=1e-6)
    for tree, ours in ((ropt.mu, opt.mu), (ropt.nu, opt.nu)):
        for name, want in _by_name(model, jax.tree.map(np.asarray, tree)).items():
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(ours[name].numpy(), want, rtol=MOMENT_TOL, atol=MOMENT_TOL * scale,
                                       err_msg=name)
    for name, want in _by_name(model, jax.tree.map(np.asarray, rparams)).items():
        got = state.params[name].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=ULP2, atol=1e-9, err_msg=name)


def _assert_first_step_close(model, ref_params, grads):
    """The parameters after a first step against the reference's, by the
    bars of test_train_step_update_matches_reference's docstring (``grads``:
    the reference's gradients of that step)."""
    lr = float(lr_at(OPT, 0))
    g = _by_name(model, grads)
    own = dict(model.named_parameters())
    for name, want in _by_name(model, jax.tree.map(np.asarray, ref_params)).items():
        got = own[name].detach().numpy()
        small = np.abs(g[name]) <= 1e-4 * max(float(np.abs(g[name]).max()), 1e-30)
        bar = np.where(small, 2 * lr * (1 + OPT.weight_decay), 1e-4 * lr) + ULP2 * np.abs(want) + 1e-9
        assert (np.abs(got - want) <= bar).all(), (name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b"])
def test_train_step_update_matches_reference(arch):
    """The whole first step against the reference's, from the same params.
    The first AdamW step is lr * (m / (|m| + eps')) per entry, ~lr * sign(g):
    where |g_ref| is below 1e-4 of its tensor's largest entry the two
    gradients (GRAD_TOL apart) may round to opposite signs or other
    fractions of lr, so there the parameters are held within 2 lr (plus the
    decay); elsewhere within 1e-4 lr (f32 quotient of two moments that agree
    to ~GRAD_TOL relative). Both plus 2 ulp of |p|: p - lr * (...) rounds
    to f32 once in the port, from f64 in the reference under x64."""
    rm, params, model = _pair(arch)
    batch = tiny_batch(model.cfg)
    rstate = _ref_state_after(rm, params, batch)
    _, grads = _ref_loss_and_grads(rm, params, batch)
    state, _ = make_train_step(model, OPT)(make_train_state(model), _t(batch))
    _assert_first_step_close(model, rstate.params, grads)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x22b-mwu"])
def test_remat_full_equals_none_bit_for_bit(arch):
    """remat="full" (each repetition recomputed in the backward, the mwu LP
    solved again) gives the loss and every gradient of remat="none" bit for
    bit."""
    out = []
    for remat in ("full", "none"):
        _, params, model = _pair(arch, remat=remat)
        batch = _t(tiny_batch(model.cfg))
        loss = chunked_ce_loss(model, batch)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert (g is None and out[1][1][name] is None) or torch.equal(g, out[1][1][name]), name


def test_remat_recomputes_the_router_lp(monkeypatch):
    """Under remat="full" a train step solves each layer's routing LP twice
    (the forward and the recompute), under "none" once; the LP sees no
    tensor that requires grad, and no grad mode."""
    calls = []
    solve = moe.solve_lanes

    def checked(lanes, opts):
        assert not torch.is_grad_enabled()
        for P, C, _, _ in lanes:
            for op in (*P.ops, *C.ops):
                assert not any(isinstance(v, torch.Tensor) and v.requires_grad for v in vars(op).values())
        calls.append(len(lanes))
        return solve(lanes, opts)

    monkeypatch.setattr(moe, "solve_lanes", checked)
    for remat, want in (("full", 2), ("none", 1)):
        calls.clear()
        _, _, model = _pair("mixtral-8x22b-mwu", remat=remat)
        make_train_step(model, OPT)(make_train_state(model), _t(tiny_batch(model.cfg)))
        assert len(calls) == want * model.cfg.n_layers, (remat, calls)


def test_router_lp_refuses_probs_that_require_grad():
    probs = torch.softmax(torch.randn(16, 4, requires_grad=True), dim=-1)
    with pytest.raises(ValueError, match="detach"):
        moe.routing_ops(probs, 2, 8)
    moe.routing_ops(probs.detach(), 2, 8)


def test_microbatches_match_full_batch():
    """tests/test_substrate.py:66's bars: loss rtol 1e-5, params atol 1e-5."""
    out = []
    for mb in (1, 2):
        _, _, model = _pair("minitron-4b")
        state, m = make_train_step(model, AdamWConfig(), microbatches=mb)(make_train_state(model),
                                                                           _t(tiny_batch(model.cfg, B=4)))
        out.append((float(m["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()}))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for name, p in out[0][1].items():
        np.testing.assert_allclose(p.numpy(), out[1][1][name].numpy(), atol=1e-5, err_msg=name)


def test_microbatch_accumulation_matches_reference():
    """microbatches=2 against the reference's scan at microbatches=2: the loss
    at rel 1e-5, the grad norm at 1e-4 and the updated parameters by the
    whole-step bars (the two halves hold as many targets, so their mean
    gradient is the full batch's)."""
    rm, params, model = _pair("minitron-4b")
    batch = tiny_batch(model.cfg, B=4)
    state = ref_step.TrainState(params=jax.tree.map(jnp.asarray, params), opt=ref_opt.init_opt_state(params),
                                step=jnp.zeros((), jnp.int32))
    rstate, rm_ = jax.jit(ref_step.make_train_step(rm, ref_opt.AdamWConfig(**vars(OPT)), microbatches=2))(
        state, _j(batch))
    _, m = make_train_step(model, OPT, microbatches=2)(make_train_state(model), _t(batch))
    np.testing.assert_allclose(float(m["loss"]), float(rm_["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm_["grad_norm"]), rtol=1e-4)
    _, grads = _ref_loss_and_grads(rm, params, batch)  # the full batch's: the mean of the two halves'
    _assert_first_step_close(model, rstate.params, grads)


@pytest.mark.parametrize("arch", ["yi-34b", "mixtral-8x22b"])
def test_chunked_loss_matches_unchunked_and_reference(arch):
    """tests/test_substrate.py:75's bar (rtol 1e-6) between chunk 7 and 40
    (a remainder of 5) at S 40, and the reference's chunk-7 loss at 1e-5."""
    rm, params, model = _pair(arch)
    batch = tiny_batch(model.cfg, B=2, S=40)
    with torch.inference_mode():
        l1 = chunked_ce_loss(model, _t(batch), chunk=7)
        l2 = chunked_ce_loss(model, _t(batch), chunk=40)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    ref = ref_step.chunked_ce_loss(rm, jax.tree.map(jnp.asarray, params), _j(batch), chunk=7)
    np.testing.assert_allclose(float(l1), float(ref), rtol=LOSS_TOL)


def test_chunked_loss_does_not_mask_pad_vocab():
    """The reference's ce_of takes logz over the padded vocab (no pad mask);
    Model.logits masks. A vocab of 200 padded to 256 tells them apart."""
    rcfg, cfg = (replace(c.reduced(), vocab_size=200) for c in (ref_get("minitron-4b"), get("minitron-4b")))
    assert cfg.padded_vocab == 256
    rm = RefModel(rcfg, fsdp=False)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(2)))
    model = load_jax_params(Model(cfg, device="cpu"), params)
    batch = tiny_batch(cfg)
    with torch.inference_mode():
        got = float(chunked_ce_loss(model, _t(batch), chunk=8))
        masked = model.logits(model(_t(batch)))
        lz = torch.logsumexp(masked, -1)
        ll = torch.take_along_dim(masked, torch.from_numpy(batch["targets"]).long()[..., None], -1)[..., 0]
        with_mask = float(((lz - ll) * torch.from_numpy(batch["loss_mask"])).sum() / batch["loss_mask"].sum())
    ref = float(ref_step.chunked_ce_loss(rm, jax.tree.map(jnp.asarray, params), _j(batch), chunk=8))
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL)
    assert abs(got - with_mask) > 1e-3


def test_load_jax_train_state_round_trip():
    """The reference's state after two steps, loaded: every parameter and
    moment equals its reference leaf (unstacked), count and step are ints;
    a moment of the wrong shape is refused by name."""
    rm, params, model = _pair("recurrentgemma-9b", n_layers=5)
    batch = tiny_batch(model.cfg)
    rstate = _ref_state_after(rm, params, batch, steps=2)
    state = load_jax_train_state(model, jax.tree.map(np.asarray, rstate))
    assert (state.step, state.opt.count) == (2, 2)
    assert state.params == dict(model.named_parameters())
    for tree, ours in ((rstate.params, state.params), (rstate.opt.mu, state.opt.mu), (rstate.opt.nu, state.opt.nu)):
        want = _by_name(model, jax.tree.map(np.asarray, tree))
        assert set(want) == set(ours)
        for name, a in want.items():
            assert ours[name].dtype == torch.float32
            np.testing.assert_array_equal(ours[name].detach().numpy(), a, err_msg=name)
    bad = rstate._replace(opt=rstate.opt._replace(mu={**rstate.opt.mu, "embed": rstate.opt.mu["embed"][:, :-1]}))
    with pytest.raises(ValueError, match="embed"):
        load_jax_train_state(model, jax.tree.map(np.asarray, bad))


def test_opt_state_starts_at_zero():
    _, _, model = _pair("minitron-4b")
    opt = init_opt_state(dict(model.named_parameters()))
    assert isinstance(opt, OptState) and opt.count == 0
    assert all(t.dtype == torch.float32 and not t.any() for t in (*opt.mu.values(), *opt.nu.values()))


def test_flash_attention_under_grad_raises():
    """The flash kernel has no backward (nor has the reference's): training
    with attn_impl="pallas" raises on the CPU too, inference runs."""
    cfg = replace(get("minitron-4b").reduced(), attn_impl="pallas")
    model = Model(cfg, device="cpu")
    batch = _t(tiny_batch(cfg, S=40))  # S > attn_chunk 16: the flash path
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(model, OPT)(make_train_state(model), batch)
    with torch.inference_mode():
        assert torch.isfinite(chunked_ce_loss(model, batch))
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        flash_attention(q, q, q)


def test_loss_decreases_small_lm():
    """tests/test_substrate.py:45's claim: 30 steps on the token pipeline
    drive the loss down by more than 0.2."""
    cfg = get("minitron-4b").reduced()
    model = Model(cfg, device="cpu", seed=0)
    pipe = TokenPipeline(cfg.vocab_size, seq_len=64, global_batch=8, seed=0)
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    state, losses = make_train_state(model), []
    for it in range(30):
        state, m = step(state, _t(pipe.batch_at(it)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]
