"""Test helper: the port's mLSTM and sLSTM cells computed by the
reference's, for bfloat16 holds at the model level.

A cell's float32 arithmetic rounds otherwise in XLA's CPU program than in
torch: XLA's exp, log1p and tanh are polynomial approximations, it
contracts multiply-adds into FMAs and sums its dots in its own order. The
cells' float32 outputs then differ by a few ulps, which now and then flips
the rounding of a bfloat16 activation; a deep bfloat16 network spreads one
such flip into logits a few bfloat16 ulps apart. The float32 holds (rtol
1e-5 a cell, 1e-4 the logits) check the cells' arithmetic; with the
reference's cells substituted, the bfloat16 holds check the rest of the
port's bfloat16 program (every cast and rounding around the cells) against
the reference's, as tests/test_torch_lm_moe.py takes XLA's dot for the
expert products.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import xlstm as ref_xlstm
from repro_torch.models import xlstm as port_xlstm

AS_WRITTEN = {"xla_allow_excess_precision": False}
_COMPILED = {}


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.detach().float().numpy())


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _call(name, fn, *args):
    """fn compiled as written for the shapes of args (float32 leaves)."""
    key = (name,) + tuple(np.shape(a) for a in jax.tree.leaves(args))
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(
            compiler_options=AS_WRITTEN)
    return _COMPILED[key](*args)


def _mlstm_cell(state, qkvif):
    st, h = _call("mlstm", ref_xlstm._mlstm_cell,
                  ref_xlstm.MLSTMState(*map(_jnp, state)),
                  tuple(map(_jnp, qkvif)))
    return port_xlstm.MLSTMState(*map(_torch, st)), _torch(h)


def _slstm_cell(p, state, xg):
    rec = {k: _jnp(v) for k, v in p.items() if k.startswith("r_")}
    st, h = _call("slstm", ref_xlstm._slstm_cell, rec,
                  ref_xlstm.SLSTMState(*map(_jnp, state)),
                  {g: _jnp(v) for g, v in xg.items()})
    return port_xlstm.SLSTMState(*map(_torch, st)), _torch(h)


@contextlib.contextmanager
def reference_cells(active: bool = True):
    """While active, port_xlstm's cells are the reference's (forward only:
    no autograd through them)."""
    if not active:
        yield
        return
    saved = port_xlstm._mlstm_cell, port_xlstm._slstm_cell
    port_xlstm._mlstm_cell, port_xlstm._slstm_cell = _mlstm_cell, _slstm_cell
    try:
        with torch.no_grad():
            yield
    finally:
        port_xlstm._mlstm_cell, port_xlstm._slstm_cell = saved
