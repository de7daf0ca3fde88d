"""The LM on a mesh (slice `repro_torch.sharding`, `launch.cells`,
`launch.dryrun`, the mesh train step and sharded-cache decode) against the
reference on the CPU.

Without processes: for all ten archs, every `shapes_for` cell and the
meshes {data 16, model 16}, {pod 2, data 16, model 16}, (2, 4) and (2, 2)
(the reference reads a stub mesh's `.shape`), the port's placements of the
parameters, the optimizer state (float32 and int8 moments), the caches and
the batches equal the reference's `tree_pspecs` entry for entry; the
per-rank parameter bytes of the production mesh; `model_flops_for`,
`analytic_memory_bytes` and `input_specs`; the dry run and launch.train's
--production-mesh on a world of 1; `constrain` on a DTensor in a world
of 1.

In spawned worlds of 8, 4 and 2 ranks (gloo, one spawn each, every case in
it; tests/lm_mesh_ranks.py holds the rank targets), against the port on
one device, at float32 compute:
  * qwen2 `.reduced()` (vocab 64, d_ff 64, as the reference's own mesh
    test) on (2, 4) with attn_dp: step 0's loss rtol 1e-5, every gradient
    leaf max |diff| <= 1e-4·max|leaf| (the port on one device is held to
    the reference's step the same way), the grad norm rtol 1e-4, the
    parameters after one step equal but for elements whose gradient is at
    rounding level (counted), and four more steps lower the loss;
  * the same under lowmem (bfloat16 parameters, int8 moments) on (2, 2):
    each of the 4 ranks' partial gradients of a bfloat16 leaf is rounded
    to bfloat16 before the sum over ranks, so the leaves hold within four
    bfloat16 ulps of the leaf's largest magnitude (2^-6·max|leaf|; the
    worst leaf reads 7.1e-3), not 1e-4; the grad norm, a sum over every
    element in which those roundings average out, at rtol 1e-3 (it reads
    2.0e-4 off); the parameters after a step within one bfloat16 ulp but
    where the gradient is at that level;
  * granite-moe `.reduced()` on (2, 2) with moe_ep: the experts stored over
    `model`, the MoE aux over the whole batch, one step as above;
  * ServeEngine.generate on (2, 2) over sharded caches, qwen2 `.reduced()`
    (KV over batch and seq, attn_dp) and jamba's reduced period (KV and
    Mamba states): tokens equal to one device's;
  * elastic restore: a lowmem state saved from the world of 4 (full
    arrays) restored onto 2 ranks and onto one device bit for bit, and a
    checkpoint written by the reference's CheckpointManager onto 2 ranks;
  * launch.train in the world of 2: a checkpoint at step 2, then a run that
    resumes from it;
  * 2 rows over the 4 ranks (each row on 2 ranks): the step as above;
  * every train job's rank: the bytes its MeshComm sent in one step equal
    a DryComm's count of the same step on "meta" (launch/cells.py
    `dry_train_step`).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import lm_mesh_ranks as ranks
from repro.checkpoint.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.launch import cells as ref_cells
from repro.launch import roofline as ref_roof
from repro.models import model as ref_model
from repro.sharding import rules as ref_rules
from repro.train import optim as ref_optim
from repro_torch.checkpoint.ckpt import CheckpointManager, flatten_with_paths
from repro_torch.configs import SHAPES, all_archs, get_config, shapes_for
from repro_torch.launch import cells, mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.models import model as model_lib
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib

jax.config.update("jax_default_matmul_precision", "float32")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 2, "model": 2})
# Per-rank parameter bytes on {data 16, model 16} by the reference's
# tree_pspecs over its abstract_params (build_cell's attn_dp, moe_ep and
# auto_policy): GB, and the replicated share where there is one.
TABLE = {"qwen2-1.5b": (0.060, 0.0), "llama3-405b": (7.052, 0.0),
         "qwen3-moe-235b-a22b": (3.736, 0.0),
         "mistral-large-123b": (2.435, 0.0),
         "llama-3.2-vision-90b": (3.024, 1.342)}
OVERRIDES = {"vocab_size": 64, "d_ff": 64}
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=10)
JOIN_S = 300.0


class Stub:
    """The reference's mesh as logical_to_pspec reads it: `.shape`."""

    def __init__(self, shape):
        self.shape = shape


def ref_paths(tree):
    """[(path, tuple spec)] of a reference PartitionSpec tree."""
    out = []
    for kp, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in kp)
        out.append((path, tuple(spec)))
    return out


def port_paths(axes, specs):
    return [(p, s) for p, _, s in rules_lib.leaves_with_paths(axes, specs)]


def rules_kw(cfg, mesh):
    me = mesh.get("model", 1)
    return dict(multi_pod="pod" in mesh, attn_dp=cfg.n_heads % me != 0,
                moe_ep=bool(cfg.n_experts) and cfg.n_experts % me == 0)


@functools.lru_cache(maxsize=None)
def ref_abstract(arch):
    cfg = ref_get_config(arch)
    dtype = (jnp.bfloat16 if ref_cells.auto_policy(cfg) == "lowmem"
             else jnp.float32)
    sds, axes = ref_model.abstract_params(cfg, dtype)
    opts = {}
    for kind in ("f32", "int8"):
        oc = ref_optim.OptConfig(moments_dtype=kind)
        opts[kind] = (jax.eval_shape(functools.partial(
            ref_optim.init_opt_state, cfg=oc), sds),
            ref_optim.opt_state_axes(axes, oc))
    return cfg, sds, axes, opts


# -- placements, without devices ----------------------------------------------

@pytest.mark.parametrize("arch", all_archs())
def test_placements_equal_the_references_tree_pspecs(arch):
    rcfg, sds, raxes, ropts = ref_abstract(arch)
    cfg = get_config(arch)
    meta, axes = model_lib.abstract_params(cfg)
    n_cache = 0
    for mesh in MESHES:
        kw = rules_kw(cfg, mesh)
        rr, pr = ref_rules.default_rules(**kw), rules_lib.default_rules(**kw)
        stub = Stub(mesh)
        assert port_paths(axes, rules_lib.tree_pspecs(mesh, pr, axes, meta)) \
            == ref_paths(ref_rules.tree_pspecs(stub, rr, raxes, sds))
        for kind in ("f32", "int8"):
            oc = optim_lib.OptConfig(moments_dtype=kind)
            like = optim_lib.init_opt_state(meta, oc)
            oaxes = optim_lib.opt_state_axes(axes, oc)
            rsds, rax = ropts[kind]
            assert port_paths(oaxes, rules_lib.tree_pspecs(
                mesh, pr, oaxes, like)) == ref_paths(
                ref_rules.tree_pspecs(stub, rr, rax, rsds)), kind
        for name in shapes_for(cfg):
            shape = SHAPES[name]
            got = cells.input_specs(cfg, shape)
            want = ref_cells.input_specs(rcfg, shape)
            assert list(got) == list(want)
            for k, v in got.items():
                assert tuple(v.shape) == tuple(want[k].shape), (name, k)
                assert str(v.dtype).split(".")[-1] == str(want[k].dtype)
                rspec = (ref_rules.logical_to_pspec(
                    ("batch",) + (None,) * (len(v.shape) - 1), want[k].shape,
                    rr, stub) if want[k].shape else P())
                assert cells.batch_shardings(got, mesh, pr)[k].spec == \
                    tuple(rspec), (name, k)
            if shape.kind == "train":
                continue
            b, s = shape.global_batch, shape.seq_len
            rc = jax.eval_shape(functools.partial(
                ref_model.init_cache, rcfg, b, s, dtype=jnp.bfloat16))
            pc = model_lib.init_cache(cfg, b, s, torch.bfloat16, "meta")
            caxes = model_lib.cache_axes(cfg)
            got_c = port_paths(caxes, rules_lib.tree_pspecs(mesh, pr, caxes,
                                                            pc))
            assert got_c == ref_paths(ref_rules.tree_pspecs(
                stub, rr, ref_model.cache_axes(rcfg), rc)), name
            n_cache += len(got_c)
    assert n_cache > 0


def _bytes(specs, dtypes, mesh, shapes, itemsize=None):
    """(bytes one rank holds, of them replicated) of leaves of `shapes`
    and `dtypes` (numpy) placed by `specs`."""
    total = rep = 0
    for spec, dtype, shape in zip(specs, dtypes, shapes):
        size = itemsize or dtype.itemsize
        b = rules_lib.placed_bytes(mesh, spec, tuple(shape), size)
        total += b
        rep += b if not rules_lib.spec_axes(spec) else 0
    return total, rep


@pytest.mark.parametrize("arch", sorted(TABLE))
def test_per_rank_parameter_bytes_equal_the_table(arch):
    """The port's placements over the reference's leaves give the table's
    bytes; the port's own dry run gives them for the float32 policy, and,
    under lowmem, the same placements at 2 bytes every leaf (the
    reference's `init_params(dtype=bfloat16)` leaves its numpy-scaled
    dense leaves in float32; the port's lowmem leaves are all
    bfloat16)."""
    _, sds, _, _ = ref_abstract(arch)
    cfg = get_config(arch)
    mesh = mesh_lib.production_mesh_shape()
    meta, axes = model_lib.abstract_params(cfg)
    rules = rules_lib.default_rules(**rules_kw(cfg, mesh))
    specs = [s for _, _, s in rules_lib.leaves_with_paths(
        axes, rules_lib.tree_pspecs(mesh, rules, axes, meta))]
    total, rep = _bytes(specs, [np.dtype(x.dtype) for x in
                                jax.tree.leaves(sds)], mesh,
                        shapes=[x.shape for x in jax.tree.leaves(sds)])
    want, want_rep = TABLE[arch]
    assert round(total / 1e9, 3) == want
    assert round(rep / 1e9, 3) == want_rep
    cell = cells.build_cell(arch, "train_4k", mesh, False)
    got = step_lib.tree_bytes(cell.in_shardings[0], cell.args_sds[0])
    if cell.policy == "f32":
        assert got == total
    else:
        shapes = [p.shape for _, p in flatten_with_paths(meta)]
        assert got == _bytes(specs, [None] * len(shapes), mesh, shapes,
                             itemsize=2)[0] < total


@pytest.mark.parametrize("arch", all_archs())
def test_roofline_and_input_specs_equal_the_references(arch):
    rcfg = ref_get_config(arch)
    cfg = get_config(arch)
    for name in shapes_for(cfg):
        shape = SHAPES[name]
        assert roofline.model_flops_for(cfg, shape.kind, shape.seq_len,
                                        shape.global_batch) == \
            ref_roof.model_flops_for(rcfg, shape.kind, shape.seq_len,
                                     shape.global_batch)
        for mesh in MESHES:
            for policy in ("f32", "lowmem"):
                attn = cfg.n_heads % mesh.get("model", 1) != 0
                assert roofline.analytic_memory_bytes(
                    cfg, shape.kind, shape.seq_len, shape.global_batch,
                    policy, mesh, attn_dp=attn) == \
                    ref_roof.analytic_memory_bytes(
                        rcfg, shape.kind, shape.seq_len, shape.global_batch,
                        policy, mesh, attn_dp=attn)
    assert cells.auto_policy(cfg) == ref_cells.auto_policy(rcfg)


def test_rules_placements_and_context():
    rules = rules_lib.default_rules(multi_pod=True)
    mesh = {"pod": 2, "data": 4, "model": 2}
    spec = rules_lib.logical_to_pspec(("batch", "embed", "mlp"),
                                      (16, 8, 6), rules, mesh)
    # batch takes pod and data; embed's data is used; mlp over model
    assert spec == (("pod", "data"), None, "model")
    assert spec == tuple(ref_rules.logical_to_pspec(
        ("batch", "embed", "mlp"), (16, 8, 6),
        ref_rules.default_rules(multi_pod=True), Stub(mesh)))
    sh = rules_lib.NamedSharding(mesh, spec)
    assert [str(p) for p in sh.placements] == ["S(0)", "S(0)", "S(2)"]
    # pod is the major of the two: coordinate (pod 1, data 2) holds block
    # 1·4 + 2 = 6 of 8 along dim 0
    assert rules_lib.shard_index(spec, mesh, {"pod": 1, "data": 2,
                                              "model": 1}) == (6, 0, 1)
    assert rules_lib.shard_slices(spec, (16, 8, 6), mesh, {
        "pod": 1, "data": 2, "model": 1}) == (slice(12, 14), slice(0, 8),
                                              slice(3, 6))
    assert rules_lib.batch_pspec(rules, 3) == tuple(
        ref_rules.batch_pspec(ref_rules.default_rules(multi_pod=True), 3))
    x = torch.ones(3)
    assert rules_lib.constrain(x, ("batch",)) is x
    with rules_lib.activate(mesh, rules):
        assert rules_lib.constrain(x, ("batch",)) is x
    # the model's axes tree has the paths of its parameter tree
    model = model_lib.init_params(get_config("jamba-v0.1-52b").reduced(),
                                  torch.Generator().manual_seed(0))
    assert [p for p, _ in flatten_with_paths(model.param_tree())] == \
        [p for p, *_ in rules_lib.leaves_with_paths(model.param_axes())]
    meta, _ = model_lib.abstract_params(get_config("llama3-405b"))
    assert all(t.device.type == "meta"
               for _, t in flatten_with_paths(meta))


def test_dryrun_and_production_mesh_on_a_world_of_one():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all"], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "All 64 dry-run cells placed OK." in run.stdout
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("[llama3-405b × train_4k @ pod]")]
    assert len(line) == 1 and "params 3.667 GB" in line[0], line
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--production-mesh", "--reduced", "--device", "cpu", "--steps", "1"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert run.returncode == 1
    assert "needs a world of 256 ranks; this one has 1" in run.stderr


def test_global_moe_dispatch_trains_on_one_device_and_not_on_the_mesh(
        tmp_path):
    """make_train_step builds and runs a one-device step of a MoE config
    with the "global" dispatch (its loss loss_fn's, the parameters moved);
    the same step refuses it on a ShardedLM, when called."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              moe_dispatch="global")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int64))
             for k in ("tokens", "labels")}
    step_cfg = step_lib.StepConfig()
    opt_cfg = optim_lib.OptConfig(**OPT)
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
    model = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model_lib.loss_fn(model, cfg, batch,
                                    compute_dtype=step_cfg.compute_dtype)
    before = {p: t.detach().clone()
              for p, t in flatten_with_paths(model.param_tree())}
    opt = optim_lib.init_opt_state(model.param_tree(), opt_cfg)
    _, opt, m = step(model, opt, batch)
    np.testing.assert_allclose(m["loss"].item(), want.item(), rtol=1e-6)
    assert np.isfinite(m["grad_norm"].item()) and m["grad_norm"] > 0
    moved = [p for p, t in flatten_with_paths(model.param_tree())
             if not torch.equal(t, before[p])]
    assert "layers/0/moe/wi" in moved, moved
    with mesh_lib.process_group(0, 1, str(tmp_path / "store")):
        params, mopt = step_lib.place_state(
            model, None, mesh_lib.make_host_mesh(), rules_lib.default_rules(),
            opt_cfg)
        with pytest.raises(ValueError, match="'global' MoE dispatch"):
            step(params, mopt, batch)


# -- worlds of ranks ----------------------------------------------------------

def qwen_job(**kw):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, 64, (8, 16)).astype(np.int32)}
    return {"arch": "qwen2-1.5b", "overrides": OVERRIDES, "batch": batch,
            "opt": OPT, **kw}


def ref_weights():
    """The reference's init (key 0) of the reduced qwen2, as numpy."""
    cfg = dataclasses.replace(ref_get_config("qwen2-1.5b").reduced(),
                              **OVERRIDES)
    params, _ = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def granite_job():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return {"arch": "granite-moe-3b-a800m", "batch": batch, "opt": OPT,
            "model_axis": 2, "moe_ep": True, "more": 2}


def serve_jobs():
    rng = np.random.default_rng(2)
    return [
        {"arch": "qwen2-1.5b", "model_axis": 2, "attn_dp": True,
         "prompts": rng.integers(0, 128, (4, 8)).astype(np.int32),
         "n_new": 6},
        {"arch": "jamba-v0.1-52b", "model_axis": 2,
         "prompts": rng.integers(0, 128, (4, 16)).astype(np.int32),
         "n_new": 4}]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    weights = ref_weights()
    saved = str(tmp / "from4")
    ref_saved = str(tmp / "reference")
    RefCheckpointManager(ref_saved, async_save=False).save(
        1, {"params": weights})
    train8 = qwen_job(weights=weights, model_axis=4, attn_dp=True, more=4)
    lowmem = qwen_job(policy="lowmem", model_axis=2, more=4, save=saved)
    out = {"train8": mesh_lib.run_ranks(ranks.run_jobs, 8,
                                        [("train", train8)],
                                        timeout=JOIN_S),
           "jobs": {"train8": train8, "lowmem": lowmem,
                    "granite": granite_job(), "serve": serve_jobs()},
           "saved": saved, "ref_saved": ref_saved, "weights": weights}
    # a batch of 2 rows over 4 ranks: each row on 2 ranks
    rows2 = qwen_job(model_axis=2, more=1)
    rows2["batch"] = {k: v[:2] for k, v in rows2["batch"].items()}
    out["jobs"]["rows2"] = rows2
    out["world4"] = mesh_lib.run_ranks(
        ranks.run_jobs, 4, [("train", lowmem), ("train", out["jobs"]["granite"])]
        + [("serve", j) for j in out["jobs"]["serve"]] + [("train", rows2)],
        timeout=JOIN_S)
    ckpt = str(tmp / "launch")
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir", ckpt]
    restore = {"arch": "qwen2-1.5b", "overrides": OVERRIDES,
               "model_axis": 2, "restore": [(saved, "int8"),
                                            (ref_saved, None)]}
    out["world2"] = mesh_lib.run_ranks(
        ranks.run_jobs, 2, [("restore", restore),
                            ("launch_train", [argv + ["--steps", "2"],
                                              argv + ["--steps", "3"]])],
        timeout=JOIN_S)
    return out


def test_train_step_on_2x4_matches_one_device_and_the_reference(worlds):
    job = worlds["jobs"]["train8"]
    want = ranks.one_device(job)
    # the port on one device against the reference's step
    rcfg = dataclasses.replace(ref_get_config("qwen2-1.5b").reduced(),
                               **OVERRIDES)
    batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, rcfg, batch,
                                    compute_dtype=jnp.float32, remat=False),
        has_aux=True))(worlds["weights"])
    np.testing.assert_allclose(want["loss"], float(rloss), rtol=1e-5)
    for path, w in flatten_with_paths(jax.tree.map(np.asarray, rgrads)):
        assert np.abs(want["grads"][path] - w).max() <= \
            1e-4 * np.abs(w).max(), path
    res = [r[0] for r in worlds["train8"]]
    assert len(res) == 8
    gaps = ranks.hold_step(res, want, 1e-4, "(2, 4) f32")
    print(f"(2, 4): {gaps['off']} parameter elements off at rounding-level "
          f"gradients; {gaps}")
    # every rank stores its blocks only: together one copy of each
    # distinct block, rank by rank as the placements predict
    cfg = ranks.config(job)
    sh = step_lib.build_shardings(cfg, {"data": 2, "model": 4},
                                  ranks.rules_for(job),
                                  step_lib.StepConfig(),
                                  optim_lib.OptConfig())
    predicted = step_lib.tree_bytes(sh["params_sharding"], sh["params_sds"])
    assert all(r["placed_bytes"] == predicted for r in res)
    full = sum(t.numel() * 4 for _, t in flatten_with_paths(
        sh["params_sds"]))
    assert predicted < full


def test_lowmem_step_on_2x2_matches_one_device(worlds):
    job = worlds["jobs"]["lowmem"]
    res = [r[0] for r in worlds["world4"]]
    gaps = ranks.hold_step(res, ranks.one_device(job), 2.0 ** -6,
                           "(2, 2) lowmem", bf16=True, norm_rtol=1e-3)
    print(f"lowmem: {gaps['off']} parameter elements off at rounding-level "
          f"gradients; {gaps}")


def test_moe_step_on_2x2_stores_experts_over_model(worlds):
    job = worlds["jobs"]["granite"]
    res = [r[1] for r in worlds["world4"]]
    want = ranks.one_device(job)
    assert want["aux"] > 0
    for r in res:
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)
    ranks.hold_step(res, want, 1e-4, "(2, 2) moe_ep")
    cfg = ranks.config(job)
    e = cfg.n_experts
    for r in res:
        for name in ("wi", "wg", "wo"):
            block = r["blocks"][f"layers/0/moe/{name}"]
            assert block[1] == e // 2, (name, block)


def test_batch_smaller_than_the_world_splits_each_row_over_ranks(worlds):
    """2 rows over 4 ranks: each row on 2 ranks, each carrying a quarter
    of the mean; the step equals one device's."""
    job = worlds["jobs"]["rows2"]
    res = [r[4] for r in worlds["world4"]]
    ranks.hold_step(res, ranks.one_device(job), 1e-4, "2 rows on (2, 2)")


def test_dry_comm_counts_the_bytes_of_the_live_step(worlds):
    """A DryComm's count of a rank's mesh train step on meta equals the
    bytes the rank's MeshComm sent in the same step over gloo: (2, 4) f32,
    (2, 2) lowmem (int8 rows gathered), (2, 2) MoE, 2 rows on 4 ranks."""
    res = [r[0] for r in worlds["train8"]] + [
        r[i] for r in worlds["world4"] for i in (0, 1, 4)]
    assert len(res) == 20
    for r in res:
        assert r["step_bytes"] == r["dry_bytes"], r["rank"]
        assert r["step_bytes"]["all_gather"] > 0
        assert r["step_bytes"]["all_to_all"] > 0


def test_sharded_cache_decode_gives_one_devices_tokens(worlds):
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    for i, job in enumerate(worlds["jobs"]["serve"]):
        res = [r[2 + i] for r in worlds["world4"]]
        cfg = ranks.config(job)
        engine = ServeEngine(cfg, ranks.model_for(job),
                             ServeConfig(batch=job["prompts"].shape[0]),
                             ranks.F32Step())
        want = engine.generate(job["prompts"], job["n_new"])
        for r in res:
            np.testing.assert_array_equal(r["tokens"], want)
        # the KV cache is split over batch (data) and over the heads or
        # the sequence (model): every rank holds a quarter of it
        specs = res[0]["cache_specs"]
        assert all(rules_lib.spec_axes(s) for s in specs), specs
        kv = [s for s in specs if len(s) >= 3]
        assert kv and all(set(rules_lib.spec_axes(s)) == {"data", "model"}
                          for s in kv), specs


def test_elastic_restore_from_4_onto_2_and_onto_1(worlds, tmp_path):
    saved = worlds["world4"][0][0]["saved"]
    (step, onto2), (rstep, ref2) = worlds["world2"][0][0]["restored"]
    assert step == rstep == 1
    assert list(onto2) == list(saved)
    for path, want in saved.items():
        np.testing.assert_array_equal(onto2[path], want, err_msg=path)
        assert onto2[path].dtype == want.dtype, path
    for path, want in flatten_with_paths(worlds["weights"]):
        np.testing.assert_array_equal(ref2["params/" + path], want)
    # onto one device: the arrays as written; and a world-1 mesh's blocks
    cfg = ranks.config(worlds["jobs"]["lowmem"])
    meta, axes = model_lib.abstract_params(cfg)
    oc = optim_lib.OptConfig(moments_dtype="int8")
    like = {"params": meta, "opt": optim_lib.init_opt_state(meta, oc)}
    _, one = CheckpointManager(worlds["saved"]).restore(like)
    for path, arr in flatten_with_paths(one):
        arr = arr.view(np.int16) if arr.dtype.kind == "V" else arr
        np.testing.assert_array_equal(arr, saved[path], err_msg=path)
    rules = rules_lib.default_rules()
    with mesh_lib.process_group(0, 1, str(tmp_path / "store")):
        m = mesh_lib.make_host_mesh()
        sh = {"params": rules_lib.tree_shardings(m, rules, axes, meta),
              "opt": rules_lib.tree_shardings(
                  m, rules, optim_lib.opt_state_axes(axes, oc), like["opt"])}
        _, blocks = CheckpointManager(worlds["saved"]).restore(
            like, shardings=sh)
    for path, t in flatten_with_paths(blocks):
        got = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(got.numpy(), saved[path],
                                      err_msg=path)


def test_launch_train_in_a_world_of_two_saves_and_resumes(worlds):
    for rank_runs in worlds["world2"]:
        first, second = rank_runs[1]
        assert "[train] done: first loss" in first, first
        assert "[train] mesh" in first, first
        assert "[loop] resumed from step 2" in second, second
        assert "[train] done" in second, second


def test_constrain_redistributes_a_dtensor_under_activate(tmp_path):
    """Under `activate`, a DTensor takes the placements the rules give its
    logical axes (a plain tensor and no context: unchanged)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rules = rules_lib.default_rules()
    with mesh_lib.process_group(0, 1, str(tmp_path / "store")):
        m = mesh_lib.make_host_mesh()
        x = distribute_tensor(torch.arange(12.0).reshape(4, 3), m,
                              [Replicate(), Replicate()])
        assert rules_lib.constrain(x, ("batch", None)) is x
        with rules_lib.activate(m, rules):
            y = rules_lib.constrain(x, ("batch", None))
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), x.full_tensor())
