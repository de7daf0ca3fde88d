"""Rank targets of the LM mesh tests (tests/test_torch_lm_mesh.py on the
CPU, tests/test_torch_cuda.py on the card), run in spawned ranks by
`repro_torch.launch.mesh.run_ranks`. Jax-free: a rank imports torch and
the port only. Each target takes one `job` dict and returns plain values
(numpy for tensors), rank 0 the bulky ones."""
from __future__ import annotations

import contextlib
import dataclasses
import io

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                        flatten_with_paths)
from repro_torch.configs import get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.sharding import lm as mesh_lm
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib


class F32Step(step_lib.StepConfig):
    """A StepConfig whose compute is float32 (the holds' precision)."""

    @property
    def compute_dtype(self):
        return torch.float32


def config(job):
    cfg = get_config(job["arch"]).reduced()
    return dataclasses.replace(cfg, **job.get("overrides", {}))


def model_for(job, device="cpu"):
    """The same full model on every rank: the job's numpy weights (the
    reference's, by path), or the port's init from seed 0; in the policy's
    dtype."""
    cfg = config(job)
    dtype = torch.bfloat16 if job.get("policy") == "lowmem" else \
        torch.float32
    if job.get("weights") is None:
        return model_lib.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), dtype)
    model = model_lib.empty(cfg, device, dtype)
    model.load_state_dict({
        # a copy: training writes the parameters in place
        path.replace("/", "."): torch.from_numpy(np.array(w)).to(
            device=device, dtype=dtype)
        for path, w in flatten_with_paths(job["weights"])}, assign=True)
    return model


def rules_for(job):
    return rules_lib.default_rules(attn_dp=job.get("attn_dp", False),
                                   moe_ep=job.get("moe_ep", True))


def host(t) -> np.ndarray:
    """A float32 numpy copy (training goes on writing `t` in place)."""
    return t.detach().float().cpu().numpy().copy()


def on_device(job) -> str:
    """The job's device; a rank on a card takes cuda:0 (the ranks share a
    one-card machine's), float32 products in float32."""
    device = job.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def train_rank(job) -> dict:
    """The mesh's step-0 loss and gradients (rank 0 returns the full
    gradients), one AdamW step (rank 0 returns the full parameters after
    it), then `job["more"]` steps on the same batch: their losses; each
    rank's placed bytes and its local block shapes."""
    device = on_device(job)
    cfg = config(job)
    step_cfg = F32Step(policy=job.get("policy", "f32"),
                       remat=job.get("remat", True))
    opt_cfg = optim_lib.OptConfig(**job["opt"])
    mesh = make_host_mesh(job["model_axis"])
    model = model_for(job, device)
    params, opt = step_lib.place_state(
        model, optim_lib.init_opt_state(model.param_tree(),
                                        step_cfg.opt_config(opt_cfg)),
        mesh, rules_for(job))
    del model
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    metrics, grads = mesh_lm.loss_and_grads(params, cfg, batch, step_cfg)
    comm = params.comm
    full_grads = {p: host(mesh_lm.gather_full(comm, [g],
                                              [params.spec[p]])[0])
                  for p, g in grads.items()}
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
    sent = dict(comm.bytes)
    _, opt, m = step(params, opt, batch)
    step_bytes = {k: comm.bytes[k] - sent[k] for k in sent}
    full = mesh_lm.gather_tree(comm, params.param_tree(),
                               params.sharding_tree())
    losses = [m["loss"].item()]
    for _ in range(job.get("more", 0)):
        _, opt, m2 = step(params, opt, batch)
        losses.append(m2["loss"].item())
    out = {"loss": metrics["loss"].item(), "ce": metrics["ce"].item(),
           "aux": metrics["aux"].item(), "grad_norm": m["grad_norm"].item(),
           "losses": losses, "placed_bytes": params.placed_bytes(),
           "blocks": {p: tuple(t.shape) for p, t in params.local.items()},
           "rank": comm.rank, "step_bytes": step_bytes,
           "dry_bytes": cells.dry_train_step(
               cfg, mesh, rules_for(job), step_cfg, opt_cfg, batch,
               comm.rank).bytes}
    if comm.rank == 0:
        out["grads"] = full_grads
        out["params"] = {p: host(t) for p, t in flatten_with_paths(full)}
    if job.get("save"):
        state = {"params": params.param_tree(), "opt": opt}
        shardings = mesh_lm.state_shardings(params, opt)
        whole = mesh_lm.gather_tree(comm, state, shardings)
        if comm.rank == 0:
            CheckpointManager(job["save"], async_save=False).save(1, whole)
            out["saved"] = {p: np.asarray(t.view(torch.int16) if
                                          t.dtype == torch.bfloat16 else t)
                            for p, t in flatten_with_paths(whole)}
        comm.barrier()
    return out


def serve_rank(job) -> dict:
    """The mesh's prefill of the job's prompts (this rank's block of the
    logits and its rows), then ServeEngine.generate over the mesh (sharded
    caches): the tokens, and every rank's cache block shapes."""
    device = on_device(job)
    cfg = config(job)
    mesh = make_host_mesh(job["model_axis"])
    comm = mesh_lm.MeshComm(mesh)
    params = mesh_lm.ShardedLM.place(model_for(job, device), comm,
                                     rules_for(job), requires_grad=False)
    b, plen = job["prompts"].shape[0], job["prompts"].shape[-1]
    prompts = torch.from_numpy(job["prompts"])
    sent = dict(comm.bytes)
    logits, _ = step_lib.make_prefill_step(cfg, F32Step())(
        params, prompts, mesh_lm.init_local_cache(params, b, plen))
    prefill_bytes = {k: comm.bytes[k] - sent[k] for k in sent}
    _, rows = mesh_lm.batch_rows(params, b)
    dry = cells.dry_serve_step(cfg, mesh, rules_for(job), F32Step(),
                               prompts, plen, rank=comm.rank)
    engine = ServeEngine(cfg, params, ServeConfig(batch=job["prompts"].shape[0]),
                         F32Step())
    tokens = engine.generate(job["prompts"], job["n_new"])
    caches = mesh_lm.init_local_cache(params, job["prompts"].shape[0],
                                      job["prompts"].shape[-1] + job["n_new"])
    return {"tokens": tokens, "rank": comm.rank, "logits": host(logits),
            "rows": (rows.start, rows.stop), "prefill_bytes": prefill_bytes,
            "dry_prefill_bytes": {k: int(v) for k, v in
                                  dry.collective_bytes.items()},
            "cache_blocks": [tuple(t.shape) for _, _, t in
                             rules_lib.leaves_with_paths(
                                 model_lib.cache_axes(cfg), caches.local)],
            "cache_specs": [s for _, _, s in rules_lib.leaves_with_paths(
                model_lib.cache_axes(cfg), caches.specs)]}


def restore_rank(job) -> dict:
    """Each checkpoint of `job["restore"]` ((directory, like tree) pairs)
    restored onto this world's mesh by its placements, gathered back to
    full arrays (rank 0 returns them as numpy)."""
    cfg = config(job)
    mesh = make_host_mesh(job["model_axis"])
    comm = mesh_lm.MeshComm(mesh)
    rules = rules_for(job)
    _, axes = model_lib.abstract_params(cfg)
    out = {"rank": comm.rank, "restored": []}
    for directory, opt in job["restore"]:
        meta, _ = model_lib.abstract_params(cfg)
        sh = {"params": rules_lib.tree_shardings(mesh, rules, axes, meta)}
        like = {"params": meta}
        if opt is not None:
            opt_cfg = optim_lib.OptConfig(moments_dtype=opt)
            like["opt"] = optim_lib.init_opt_state(meta, opt_cfg)
            sh["opt"] = rules_lib.tree_shardings(
                mesh, rules, optim_lib.opt_state_axes(axes, opt_cfg),
                like["opt"])
        step, state = CheckpointManager(directory).restore(like,
                                                           shardings=sh)
        whole = mesh_lm.gather_tree(comm, state, sh)
        out["restored"].append(
            (step, {p: np.asarray(t.view(torch.int16) if
                                  t.dtype == torch.bfloat16 else t)
                    for p, t in flatten_with_paths(whole)}
             if comm.rank == 0 else None))
    return out


def launch_train_rank(argv_runs) -> list[str]:
    """launch.train's main in this rank's process group, once per argv:
    its printed lines."""
    from repro_torch.launch import train as train_lib
    out = []
    for argv in argv_runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_lib.main(list(argv))
        out.append(buf.getvalue())
    return out


def one_device(job):
    """The port on one device (the job's): step 0's loss and gradients,
    one step's parameters and grad norm, then job["more"] steps'
    losses."""
    cfg = config(job)
    step_cfg = F32Step(policy=job.get("policy", "f32"))
    opt_cfg = optim_lib.OptConfig(**job["opt"])
    device = on_device(job)
    model = model_for(job, device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in job["batch"].items()}
    loss, parts = model_lib.loss_fn(model, cfg, batch,
                                    compute_dtype=torch.float32)
    leaves = flatten_with_paths(model.param_tree())
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    opt = optim_lib.init_opt_state(model.param_tree(),
                                   step_cfg.opt_config(opt_cfg))
    step = step_lib.make_train_step(cfg, opt_cfg, step_cfg)
    _, opt, m = step(model, opt, batch)
    params = {p: host(t) for p, t in flatten_with_paths(
        model.param_tree())}
    losses = [m["loss"].item()]
    for _ in range(job.get("more", 0)):
        _, opt, m2 = step(model, opt, batch)
        losses.append(m2["loss"].item())
    return {"loss": loss.item(), "aux": parts["aux"].item(),
            "grads": {p: host(g) for (p, _), g in zip(leaves, grads)},
            "grad_norm": m["grad_norm"].item(), "params": params,
            "losses": losses}


def hold_step(res, want, grad_tol, label, bf16=False, norm_rtol=1e-4):
    """Every rank's metrics equal; rank 0's loss (rtol 1e-5), grad norm
    (rtol norm_rtol), gradients (max |diff| <= grad_tol·max|leaf|)
    and parameters after one step against one device's, and the loss
    lower after the more steps. After the step (AdamW's first is ~sign(g),
    its slope ~eps/|g| near 0) a parameter element may differ only where
    its one-device gradient is at rounding level, |g| <= 1e-3·max|leaf|
    (grad_tol under bfloat16); and under bfloat16 parameters any element
    by its rounding, one bfloat16 ulp (2^-7·|p|). Returns {"off": the
    count of elements off by more than 1e-5 relative, "norm": the grad
    norm's relative gap, "grads": the largest max|diff|/max|leaf| of a
    gradient leaf}."""
    for r in res[1:]:
        assert (r["loss"], r["grad_norm"], r["losses"]) == \
            (res[0]["loss"], res[0]["grad_norm"], res[0]["losses"]), label
    got = res[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               err_msg=label)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=norm_rtol, err_msg=label)
    assert list(got["grads"]) == list(want["grads"])
    grad_gap = 0.0
    for path, w in want["grads"].items():
        g = got["grads"][path]
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= grad_tol * np.abs(w).max(), \
            (label, path, np.abs(g - w).max(), np.abs(w).max())
        if np.abs(w).max() > 0:
            grad_gap = max(grad_gap,
                           float(np.abs(g - w).max() / np.abs(w).max()))
    off_count = 0
    for path, w in want["params"].items():
        d = np.abs(got["params"][path] - w)
        off = d > 1e-5 * np.abs(w) + 1e-7
        g = np.abs(want["grads"][path])
        tiny = g <= (grad_tol if bf16 else 1e-3) * g.max()
        big = off & (d > (2.0 ** -7 * np.abs(w) if bf16 else 0.0))
        assert not (big & ~tiny).any(), (label, path, d[big & ~tiny])
        off_count += int(off.sum())
    assert got["losses"][-1] < got["losses"][0], (label, got["losses"])
    return {"off": off_count, "grads": grad_gap,
            "norm": abs(got["grad_norm"] / want["grad_norm"] - 1.0)}


TARGETS = {"train": train_rank, "serve": serve_rank,
           "restore": restore_rank, "launch_train": launch_train_rank}


def run_jobs(jobs) -> list:
    """Several (kind, job) in one world, in order: one spawn for all."""
    return [TARGETS[kind](job) for kind, job in jobs]
