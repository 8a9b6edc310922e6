"""The port's checkpoints and Trainer vs ``repro.checkpoint`` /
``repro.train.trainer``, on the CPU.

The layout is the reference's (``step_N/shard_0.npz`` + ``manifest.json``,
leaves ``leaf_i`` in the order of ``jax.tree.flatten``), so a checkpoint
of a tree of dicts written by one package restores in the other, exactly.
The Trainer's restart is held bit for bit (the reference's own test holds
its loss within 1e-4): the port's step is deterministic on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint.ckpt import latest_step, restore_latest, save, save_async, wait_pending
from repro_torch.configs import get
from repro_torch.models import Model
from repro_torch.train import Trainer, TrainerConfig, make_train_state


def _tree():
    return {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3)), "d": torch.zeros(4, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_substrate.py:83, with tensor leaves: restored in place into the like tree."""
    tree = _tree()
    save(tmp_path, 3, tree)
    save(tmp_path, 7, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 3, "d": tree["b"]["d"] + 1}})
    assert latest_step(tmp_path) == 7
    like = _tree()
    restored, step = restore_latest(tmp_path, like)
    assert step == 7
    assert restored["a"] is like["a"]  # the like tree's own tensors, filled
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(5) * 2)
    np.testing.assert_array_equal(restored["b"]["c"].numpy(), np.full((2, 3), 3.0))
    assert restored["b"]["d"].dtype == torch.int32 and restored["b"]["d"].tolist() == [1, 1, 1, 1]
    assert restore_latest(tmp_path / "none", like) == (None, None)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_latest(tmp_path, {"a": like["a"]})


def test_checkpoint_layout_is_the_reference_one(tmp_path):
    """The same tree written by each package: the same files and manifest
    keys, and each restores the other's checkpoint exactly."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32), "z": {"b": rng.standard_normal(5),
                                                                        "a": np.arange(6, dtype=np.int32)}}
    save(tmp_path / "port", 2, {k: v if k == "w" else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                               for k, v in arrays.items()})
    ref_ckpt.save(tmp_path / "ref", 2, jax.tree.map(jnp.asarray, arrays))
    for d in ("port", "ref"):
        assert sorted(p.name for p in (tmp_path / d / "step_2").iterdir()) == ["manifest.json", "shard_0.npz"]
    mp, mr = (json.loads((tmp_path / d / "step_2" / "manifest.json").read_text()) for d in ("port", "ref"))
    assert sorted(mp) == sorted(mr) and mp["n_leaves"] == mr["n_leaves"] == 3 and mp["shards"] == mr["shards"]
    with np.load(tmp_path / "port" / "step_2" / "shard_0.npz") as zp, \
            np.load(tmp_path / "ref" / "step_2" / "shard_0.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            np.testing.assert_array_equal(zp[k], zr[k])
    got, step = ref_ckpt.restore_latest(tmp_path / "port", arrays)
    assert step == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(arrays)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_async_and_gc(tmp_path):
    """tests/test_substrate.py:93."""
    tree = {"w": torch.zeros((4,))}
    for s in range(5):
        save_async(tmp_path, s, tree, keep=2)
    wait_pending()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_checkpoint_ignores_partial(tmp_path):
    """tests/test_substrate.py:102: a directory without a manifest (a torn
    write), and an uncommitted staging directory, are not restorable."""
    tree = {"w": torch.zeros((4,))}
    save(tmp_path, 1, tree)
    (tmp_path / "step_9").mkdir()
    (tmp_path / "_staging_step_12").mkdir()
    assert latest_step(tmp_path) == 1
    assert restore_latest(tmp_path, tree)[1] == 1


def test_async_save_not_torn_by_in_place_update(tmp_path):
    """save_async copies every leaf before it returns: the optimizer's next
    in-place update (here, right after the call, while the write is still
    pending) does not reach the checkpoint."""
    w = torch.arange(1 << 20, dtype=torch.float32)
    state = {"params": {"w": w}, "opt": (w.clone(), 3), "step": 7}
    save_async(tmp_path, 7, state)
    w.add_(1.0)  # the next step, in place
    state["opt"][0].mul_(2.0)
    wait_pending()
    like = {"params": {"w": torch.zeros_like(w)}, "opt": (torch.zeros_like(w), 0), "step": 0}
    got, step = restore_latest(tmp_path, like)
    assert step == 7 and got["step"] == 7 and got["opt"][1] == 3 and isinstance(got["opt"], tuple)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.arange(1 << 20, dtype=np.float32))
    np.testing.assert_array_equal(got["opt"][0].numpy(), np.arange(1 << 20, dtype=np.float32))


def test_train_state_round_trip(tmp_path):
    """A TrainState after a step (params, moments, count, step) restores
    into a fresh model's state exactly, into the model's own parameters."""
    cfg = get("mixtral-8x22b-mwu").reduced()
    t = Trainer(cfg, TrainerConfig(steps=1, seq_len=16, global_batch=2, log_every=100), device="cpu")
    state = t.run()
    save(tmp_path, state.step, state)
    model = Model(cfg, device="cpu", seed=1)
    fresh = make_train_state(model)
    got, step = restore_latest(tmp_path, fresh)
    assert step == 1 and got.step == 1 and got.opt.count == 1
    assert got.params["embedding"] is model.embedding
    for (n, p), q in zip(t.model.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.opt.mu[n], got.opt.mu[n]) and torch.equal(state.opt.nu[n], got.opt.nu[n]), n


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b-mwu"])
def test_trainer_restart_resumes_bit_for_bit(tmp_path, arch):
    """tests/test_substrate.py:125's run: 8 steps with a checkpoint every 2,
    against 5 steps and a fresh Trainer that resumes from the last
    checkpoint: the same final parameters bit for bit and the same loss."""
    cfg = get(arch).reduced()

    def run(steps, where):
        tc = TrainerConfig(steps=steps, ckpt_every=2, seq_len=32, global_batch=4, ckpt_dir=str(tmp_path / where),
                           log_every=100)
        t = Trainer(cfg, tc, device="cpu")
        t.run()
        return t

    whole = run(8, "ck")
    run(5, "ck2")
    assert latest_step(tmp_path / "ck2") == 5
    resumed = run(8, "ck2")
    assert resumed.final_state.step == 8 and latest_step(tmp_path / "ck2") == 8
    assert resumed.last_metrics == whole.last_metrics
    for (n, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
    assert sorted(int(p.name.split("_")[1]) for p in (tmp_path / "ck2").glob("step_*")) == [5, 6, 8]  # keep=3


def test_trainer_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(get("minitron-4b").reduced(), TrainerConfig(), mesh=object(), device="cpu")


def test_trainer_matches_reference_first_loss():
    """The Trainer's first step on the token pipeline: the reference's
    Trainer starts from other random weights (jax.random), so the port's
    model takes the reference's initial parameters; the first loss then
    agrees at the train tests' bar (rel 1e-5)."""
    from repro.configs import get as ref_get
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefConfig
    from repro_torch.models import load_jax_params

    cfg = get("minitron-4b").reduced()
    ref = RefTrainer(ref_get("minitron-4b").reduced(), RefConfig(steps=1, seq_len=32, global_batch=4, log_every=100))
    ref.run()
    params = jax.tree.map(np.asarray, ref.model.init(jax.random.PRNGKey(0)))
    t = Trainer(cfg, TrainerConfig(steps=1, seq_len=32, global_batch=4, log_every=100), device="cpu")
    load_jax_params(t.model, params)
    t.run()
    np.testing.assert_allclose(t.last_metrics["loss"], ref.last_metrics["loss"], rtol=1e-5)
