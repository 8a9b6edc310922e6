"""The port's launch layer (``repro_torch.launch``) vs ``repro.launch`` and
the reference model's specs, on the CPU.

* ``param_spec()`` / ``cache_spec()`` of every arch (the ``-mwu`` variants
  too), fsdp on and off, every (shard_seq, shard_batch), equal the
  reference's ``Model(cfg, mesh_axes, fsdp)`` specs entry by entry, through
  the map between the two models' parameters (``models.model._by_name``;
  the reference stacks the pattern unit's repetitions behind a leading
  None, the port holds a tensor a layer).
* The per-device parameter and cache bytes of every cell on (16, 16) and
  (2, 16, 16) (``launch.dryrun.argument_bytes``) equal the same arithmetic
  over the reference's ``abstract_params()`` and ``init_caches`` shapes
  (``jax.eval_shape``, nothing compiled) and its specs, exactly.
* ``--list`` gives the reference's skip reasons.
* In subprocesses (a fake process group left in a pytest worker would reach
  the other test files of the worker): a whole cell of a reduced config over
  a fake group of 4 ranks ends ``ok`` and gives the same record twice;
  the MWU cell at a small scale; ``Trainer(mesh=make_mesh((1, 1)))`` equals
  ``Trainer()`` bit for bit over 3 steps.
"""
import io
import json
import math
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get as ref_get
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import skip_reason as ref_skip_reason
from repro.models import Model as RefModel
from repro_torch.configs import ARCH_IDS, get
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import local_shape, sharding_for
from repro_torch.models import Model
from repro_torch.models.common import P
from repro_torch.models.model import _by_name

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ARCH_IDS + ["mixtral-8x22b-mwu", "dbrx-132b-mwu"]
MESHES = {"single": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}


def _entries(spec) -> tuple:
    return tuple(spec)


def _unstacked(model, ref_tree):
    """The reference's tree with each stacked leaf (leading None) made a
    list over the repetitions of its entries, as ``_by_name`` indexes it."""
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
    blocks = jax.tree.map(lambda s: [_entries(s)[1:]] * model.reps, ref_tree["blocks"], is_leaf=is_spec)
    rest = jax.tree.map(_entries, {k: v for k, v in ref_tree.items() if k != "blocks"}, is_leaf=is_spec)
    return {**rest, "blocks": blocks}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(arch, fsdp):
    for axes in (("data", "model"), ("pod", "data", "model")):
        model = Model(get(arch), device="meta", mesh_axes=axes, fsdp=fsdp)
        ref = RefModel(ref_get(arch), mesh_axes=axes, fsdp=fsdp).param_spec()
        want = _by_name(model, _unstacked(model, ref))
        got = model.param_spec()
        assert set(got) == set(want) == {n for n, _ in model.named_parameters()}
        for name, spec in got.items():
            assert isinstance(spec, P) and _entries(spec) == tuple(want[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_reference(arch):
    model = Model(get(arch), device="meta", mesh_axes=("pod", "data", "model"))
    ref = RefModel(ref_get(arch), mesh_axes=("pod", "data", "model"))
    k = len(model.pattern_unit)
    for shard_seq in (True, False):
        for shard_batch in (True, False):
            got = model.cache_spec(shard_seq=shard_seq, shard_batch=shard_batch)
            want = ref.cache_spec(shard_seq=shard_seq, shard_batch=shard_batch)
            assert _entries(got.pos) == _entries(want.pos)
            for i, layer in enumerate(got.layers):
                stacked = i < model.reps * k
                ref_layer = want.scanned[i % k] if stacked else want.tail[i - model.reps * k]
                assert type(layer).__name__ == type(ref_layer).__name__, i
                assert [_entries(s) for s in layer] == [_entries(s)[stacked:] for s in ref_layer], \
                    (i, shard_seq, shard_batch)


def _ref_local_bytes(shape, dtype, spec, sizes) -> int:
    """The reference's leaf at its spec, shard on one device (rounded up)."""
    out = list(shape)
    for i, e in enumerate(tuple(spec)):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out[i] = -(-out[i] // math.prod(sizes[a] for a in axes))
    return math.prod(out) * np.dtype(dtype).itemsize


def _ref_tree_bytes(tree, spec_tree, sizes) -> int:
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
    leaves = jax.tree.leaves(jax.tree.map(lambda s, a: _ref_local_bytes(a.shape, a.dtype, s, sizes), spec_tree,
                                          tree, is_leaf=is_spec))
    return int(sum(leaves))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_reference(arch):
    cfg, ref_cfg = get(arch), ref_get(arch)
    abstract = {fsdp: (RefModel(ref_cfg, mesh_axes=("data", "model"), fsdp=fsdp).abstract_params())
                for fsdp in (True, False)}
    for mesh_kind, sizes in MESHES.items():
        axes = tuple(sizes)
        for name, cell in SHAPES.items():
            if ref_skip_reason(ref_cfg, REF_SHAPES[name]) is not None:
                continue
            train = cell.step == "train"
            ref = RefModel(ref_cfg, mesh_axes=axes, fsdp=train)
            got = dryrun.argument_bytes(cfg, cell, sizes)
            assert got["param_bytes"] == _ref_tree_bytes(abstract[train], ref.param_spec(), sizes), \
                (mesh_kind, name)
            if cell.step == "decode":
                dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
                shard_batch = cell.global_batch % dp == 0
                caches = jax.eval_shape(lambda: ref.init_caches(cell.global_batch, cell.seq_len))
                spec = ref.cache_spec(shard_seq=True, shard_batch=shard_batch)
                want = _ref_tree_bytes((caches.scanned, caches.tail), (spec.scanned, spec.tail), sizes)
                assert got["cache_bytes"] == want, (mesh_kind, name)


def test_local_shape_and_placements():
    sizes = MESHES["pod2"]
    assert local_shape((256, 4096, 6144), P(("pod", "data"), None, "model"), sizes) == (8, 4096, 384)
    assert local_shape((10,), P("model"), sizes) == (1,)  # rounded up, as DTensor's first chunk
    assert local_shape((8, 3), P(None), sizes) == (8, 3)

    class FakeMesh:  # what sharding_for reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

    from torch.distributed.tensor import Replicate, Shard
    got = sharding_for(FakeMesh(), {"w": P("data", "model"), "b": [P(None), P(("pod", "data"))]})
    assert got == {"w": [Replicate(), Shard(0), Shard(1)],
                   "b": [[Replicate()] * 3, [Shard(0), Shard(0), Replicate()]]}
    with pytest.raises(ValueError, match="lacks"):
        sharding_for(FakeMesh(), P("expert"))


def test_list_gives_reference_skip_reasons():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main(["--list", "--all", "--mesh", "both"]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(ARCH_IDS) * len(SHAPES) * 2
    for line in lines:
        arch, shape, mesh, rest = line.split(maxsplit=3)
        reason = ref_skip_reason(ref_get(arch), REF_SHAPES[shape])
        assert rest == ("SKIP: " + reason if reason else "run"), line
    assert any("SKIP" in x for x in lines) and any(x.endswith("run") for x in lines)


def _run(code: str, timeout: float = 240.0) -> dict:
    """``code`` in a fresh interpreter (jax blocked), its last stdout line's JSON."""
    prog = f"import sys; sys.modules['jax'] = None; sys.path.insert(0, {SRC!r})\n" + textwrap.dedent(code)
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_run_cell_on_fake_group_of_four():
    out = _run("""
        import json, torch.distributed as dist
        from dataclasses import replace
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get
        from repro_torch.configs.shapes import ShapeCell
        from repro_torch.launch import dryrun, make_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
        mesh = make_mesh((2, 2), ("data", "model"))
        recs = {}
        for arch in ("mixtral-8x22b-mwu", "mamba2-1.3b", "recurrentgemma-9b"):
            cfg = replace(get(arch).reduced(), remat="full")
            for cell in (ShapeCell("tiny_train", 32, 4, "train"), ShapeCell("tiny_prefill", 32, 4, "prefill"),
                         ShapeCell("tiny_decode", 32, 3, "decode")):
                a = dryrun.run_cell(cfg, cell, "single", mesh=mesh)
                b = dryrun.run_cell(cfg, cell, "single", mesh=mesh)
                recs[f"{arch}/{cell.name}"] = [a, json.dumps(a) == json.dumps(b)]
        print(json.dumps(recs))
    """)
    for key, (rec, same) in out.items():
        assert rec["ok"] and same, key
        assert rec["n_devices"] == 4 and rec["counts"]["flops"] > 0 and rec["memory"]["temp_bytes"] > 0, key
        assert rec["roofline"]["step_time_lb_s"] > 0, key
    train = out["mixtral-8x22b-mwu/tiny_train"][0]
    assert train["per_device_batch"] == 2 and train["depth"]["mwu_router"]["upper_bound"]
    assert {c["source"] for c in train["counts"]["collectives"]} == {"reckoned"}
    decode = out["mamba2-1.3b/tiny_decode"][0]
    assert decode["per_device_batch"] == 3 and not decode["batch_sharded"]  # 3 does not divide over 2


def test_run_mwu_cell_small():
    rec = _run("""
        import json
        from repro_torch.launch import dryrun
        print(json.dumps(dryrun.run_mwu_cell("pod2", scale=12, edgefactor=16)))
    """)
    assert rec["ok"] and rec["n_devices"] == 512 and rec["slab_edges"] == 16 * 4096 // 256
    calls = rec["iteration"]["kernel_calls"]
    assert calls == {"softmax_weights": 2, "step_direction": 1, "incidence_scatter": 1, "binary_search": 1,
                     "axpy_reduce": 3}
    issued = [c for c in rec["iteration"]["collectives"] if c["source"] == "issued"]
    assert issued and all(c["group"] == 256 for c in issued)  # the pod group: dy, dz, max(d)
    assert rec["model_flops"]["total"] == 5000 * 12.0 * 2 * 16 * 4096


def test_trainer_with_mesh_equals_trainer():
    out = _run("""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get
        from repro_torch.launch import make_mesh
        from repro_torch.train import Trainer, TrainerConfig
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
        cfg = get("mixtral-8x22b").reduced()
        tc = TrainerConfig(steps=3, seq_len=32, global_batch=2, log_every=100)
        a = Trainer(cfg, tc, device="cpu")
        b = Trainer(cfg, tc, mesh=make_mesh((1, 1), ("data", "model")), device="cpu")
        a.run(); b.run()
        same = all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
        print(json.dumps({"same": same, "metrics": [a.last_metrics, b.last_metrics],
                          "fsdp": [a.model.fsdp, b.model.fsdp], "axes": list(b.model.mesh_axes)}))
    """)
    assert out["same"] and out["metrics"][0] == out["metrics"][1]
    assert out["fsdp"] == [False, True] and out["axes"] == ["data", "model"]
