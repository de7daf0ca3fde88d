"""Bounded-error BlinkQL over training telemetry on the PyTorch/CUDA port.

Streams (step, domain, loss, grad_norm) records of a training run into a
BlinkDB table and answers ops-style questions submitted as BlinkQL TEXT
through the port's service layer (parser → admission scheduler → coalesced
shared scans → answer cache; docs/SERVICE.md): the paper's §2 user
contract applied to a trainer's own data plane. With `--train-steps N`
the table is the port trainer's own `Telemetry` (`repro_torch.train.loop`)
of N steps of the reduced qwen2 at sequence 32, batch 8, as in the
reference's example; by default the records are synthesized from a seed
in that shape, at a larger scale: one record per (step, domain), a loss
that decays with the step and differs by domain, and a heavy-tailed
gradient norm. Runs on the card; `--device cpu` runs it on the CPU.

    PYTHONPATH=src python examples/torch_telemetry_queries.py [--device cpu]
    PYTHONPATH=src python examples/torch_telemetry_queries.py --train-steps 60
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BlinkDB, EngineConfig, QueryTemplate
from repro_torch.core import table as table_lib
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import DataConfig, SyntheticTokenStream
from repro_torch.models import model as model_lib
from repro_torch.service import BlinkQLService, ServiceConfig
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib
from repro_torch.train.loop import LoopConfig, train


def telemetry(n_steps: int, n_domains: int, seed: int) -> dict:
    """One record per (step, domain) of a synthetic training run."""
    rng = np.random.default_rng(seed)
    step = np.repeat(np.arange(n_steps, dtype=np.int32), n_domains)
    domain = np.tile(np.arange(n_domains, dtype=np.int32), n_steps)
    base = 2.0 + 0.15 * domain + 6.0 / np.sqrt(1.0 + step / 50.0)
    loss = base * rng.lognormal(0.0, 0.05, step.shape)
    grad_norm = rng.lognormal(-0.3, 0.6, step.shape)
    return {"step": step, "domain": domain,
            "n_seqs": rng.integers(1, 9, step.shape).astype(np.int32),
            "loss": loss.astype(np.float32),
            "grad_norm": grad_norm.astype(np.float32)}


def trained_telemetry(n_steps: int, seed: int, device) -> dict:
    """The port trainer's own records: the reduced qwen2 trained n_steps
    at sequence 32, batch 8 (the reference example's run)."""
    cfg = get_config("qwen2-1.5b").reduced()
    device = resolve_device(device)
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    opt_cfg = optim_lib.OptConfig(lr=3e-3, warmup_steps=5, decay_steps=60)
    opt = optim_lib.init_opt_state(params.param_tree(), opt_cfg)
    step_fn = step_lib.make_train_step(cfg, opt_cfg,
                                       step_lib.StepConfig(remat=False))
    stream = SyntheticTokenStream(DataConfig(cfg.vocab_size, 32, 8,
                                             seed=seed))
    with tempfile.TemporaryDirectory(prefix="telemetry_") as tmp:
        _, _, tel = train(step_fn, params, opt, stream,
                          LoopConfig(total_steps=n_steps, ckpt_every=0,
                                     log_every=max(n_steps // 2, 1),
                                     ckpt_dir=tmp), resume=False)
    cols = tel.as_columns()
    return {"step": cols["step"].astype(np.int32),
            "domain": cols["domain"].astype(np.int32),
            "loss": cols["loss"].astype(np.float32),
            "grad_norm": cols["grad_norm"].astype(np.float32)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250_000,
                    help="steps of synthesized records")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="train the reduced qwen2 this many steps and query "
                         "its own telemetry instead")
    ap.add_argument("--domains", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.train_steps > 0:
        cols = trained_telemetry(args.train_steps, args.seed, args.device)
        n_steps, k1 = args.train_steps, 50.0
    else:
        cols = telemetry(args.steps, args.domains, args.seed)
        n_steps, k1 = args.steps, max(50.0, args.steps / 100.0)
    print(f"[telemetry] {len(cols['step'])} records, "
          f"{len(np.unique(cols['domain']))} domains")
    tbl = table_lib.from_columns("telemetry", cols, categorical=["domain"])
    db = BlinkDB(EngineConfig(k1=k1, m=3, uniform_fraction=0.5),
                 device=args.device)
    db.register_table("telemetry", tbl)
    db.build_samples("telemetry",
                     [QueryTemplate(frozenset({"domain"}), 1.0)],
                     storage_budget_fraction=0.5)

    with BlinkQLService(db, config=ServiceConfig(batch_window_s=0.002)) as svc:
        # Ops question 1: per-domain mean loss, 10% error bound.
        ans = svc.submit(
            "SELECT AVG(loss) FROM telemetry GROUP BY domain "
            "ERROR WITHIN 10% AT CONFIDENCE 95%")
        print("\nper-domain AVG(loss) within 10%@95%:")
        for g in sorted(ans.groups, key=lambda g: g.key)[:4]:
            print(f"  domain {g.key[0]}: {g.estimate:.3f} "
                  f"± {1.96 * g.stderr:.3f}")

        # Ops question 2: how many late-phase high-grad-norm events?
        late = n_steps // 2
        a2 = svc.submit(
            f"SELECT COUNT(*) FROM telemetry WHERE step >= {late} "
            "AND grad_norm > 1.0 ERROR WITHIN 20% CONFIDENCE 95%")
        if a2.groups:
            print(f"\nlate high-grad events ~= {a2.groups[0].estimate:.0f} "
                  f"± {1.96 * a2.groups[0].stderr:.0f}")
        else:
            print("\nno late high-grad events in sample")

        # Repeat of question 1: served from the answer cache (generation-
        # validated: a telemetry append would evict it).
        svc.submit("SELECT AVG(loss) FROM telemetry GROUP BY domain "
                   "ERROR WITHIN 10% AT CONFIDENCE 95%")
        # Ops question 3, EXPLAINed: the answer, the plan the engine chose
        # and where its time went (the traced stages).
        rep = svc.execute("EXPLAIN SELECT AVG(grad_norm) FROM telemetry "
                          "WHERE domain = 3 ERROR WITHIN 5%")
        plan = rep["plan"]
        print(f"\nEXPLAIN AVG(grad_norm) domain 3: family={plan['family']} "
              f"K={plan['k']:.0f} certified={plan['certified']}; stages (s): "
              + ", ".join(f"{k}={v:.4f}"
                          for k, v in sorted(rep["timings"].items())))
        print(f"\nservice stats: {svc.stats()}")


if __name__ == "__main__":
    main()
