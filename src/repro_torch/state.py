"""Carrying sampling state and LM weights from the reference package into
the port.

`jax.random` and `torch.Generator` draw different numbers from one seed, so
a family built by each package from the same seed differs row for row. To
hold the port against the reference, the reference's per-row priorities
(`repro.core.sampling.base_units(n, seed[, uniform=True])`, as numpy) are
handed to the port's builders as `units=`, and the reference's LM weights
(`repro.models.model.init_params`, as numpy) become the port model's state
through `lm_params_from_reference`, its optimizer state through
`opt_state_from_reference`. This module takes plain numpy arrays and never
imports the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (SEP, flatten_with_paths, map_leaves,
                                        to_tensor)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import BlinkDB, resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParamFactory
from repro_torch.train import optim as optim_lib


def install_families(db: BlinkDB, table_name: str,
                     units: Mapping[tuple[str, ...], np.ndarray]) -> None:
    """Build each family φ of `units` (φ = () is the uniform family) from
    the given per-row priorities and install it into `db`, through the same
    path as BlinkDB.add_family."""
    n = db.tables[table_name].n_rows
    for phi, u in units.items():
        u = np.asarray(u, dtype=np.float32)
        if u.shape != (n,):
            raise ValueError(f"units for family {phi!r} have shape {u.shape}; "
                             f"table {table_name!r} has {n} rows")
        db.add_family(table_name, phi, units=u)


def adopt_families(db: BlinkDB, table_name: str,
                   families: Mapping[tuple[str, ...], object]) -> None:
    """Install families already built (SampleFamily objects, host arrays
    only: another engine's, or unpickled) into `db` as its own: each
    family's derived state starts empty and its generation bumps, as after
    BlinkDB.add_family."""
    for phi, fam in families.items():
        db.families.setdefault(table_name, {})[tuple(phi)] = fam
        db._drop_derived(table_name, tuple(phi))
        db._bump_generation(table_name, tuple(phi))
    db._bump_generation(table_name, None)


def shard_row(block, shard: int):
    """Row `shard` of a reference [S, n_local] block, as numpy: an array,
    or a mapping of them (the reference's striped columns)."""
    if isinstance(block, Mapping):
        return {k: shard_row(v, shard) for k, v in block.items()}
    return np.asarray(block)[shard]


def lm_params_from_reference(cfg: ModelConfig, params_np,
                             device="cuda") -> dict[str, torch.Tensor]:
    """The reference's LM parameter tree (`init_params(cfg, key)[0]` as
    numpy, or a restored checkpoint's "params") as a state dict of the
    port's `DecoderLM` for `cfg`, on `device`: "layers/0/attn/wq" becomes
    "layers.0.attn.wq", shapes and dtypes kept. Load it with
    `model.load_state_dict(..., assign=True)`, which checks every name and
    shape."""
    device = resolve_device(device)
    out = {}
    for path, leaf in flatten_with_paths(params_np):
        out[path.replace(SEP, ".")] = to_tensor(leaf).to(device)
    return out


def opt_state_from_reference(cfg: ModelConfig, opt_np, device="cuda") -> dict:
    """The reference's optimizer state (`init_opt_state(params, opt_cfg)` or
    a restored checkpoint's "opt", as numpy: {"m", "v", "step"}, float32
    moments or int8 leaves {"q", "scale"}) as the port's, on `device`, the
    tree kept. Raises unless its names and shapes are those of
    `init_opt_state` for `cfg`'s parameters."""
    device = resolve_device(device)
    got = [(path, tuple(np.shape(a))) for path, a in flatten_with_paths(opt_np)]
    int8 = any(path.endswith(SEP + "q") for path, _ in got)
    meta = model_lib.DecoderLM(cfg, ParamFactory(None, torch.float32, "meta"))
    like = optim_lib.init_opt_state(meta.param_tree(), optim_lib.OptConfig(
        moments_dtype="int8" if int8 else "f32"))
    if got != [(path, tuple(t.shape)) for path, t in flatten_with_paths(like)]:
        raise ValueError(f"the optimizer state does not hold {cfg.name}'s "
                         f"parameters")
    return map_leaves(lambda leaf: to_tensor(leaf).to(device), opt_np)
