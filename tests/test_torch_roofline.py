"""The port's step accounting (repro_torch.launch.roofline, the DryComm
cells, `launch.dryrun --costs`) against the reference's roofline on the
CPU.

  * `step_flops` on small programs, as tests/test_roofline.py holds the
    reference's: one product exactly, a loop of 7 multiplying its body, 5 x
    3 nested loops under torch.utils.checkpoint, a gradient at >= 1.9x its
    forward; `Roofline`'s terms and bottleneck with the H100's constants;
  * the train step (loss, gradients, AdamW) of six reduced archs at S = 16
    and 64 on "meta" against the reference's `step_flops` of its train
    step: the products equal after the closed-form differences below, the
    totals within 15%, every op the step dispatches in the cost tables;
  * the period extrapolation equal to a direct count at 4 repeats;
  * the peak-memory tracker on a program computed by hand;
  * `Answer.max_rel_err` and `Table.column_codes` equal to the reference's;
  * `python -m repro_torch.launch.dryrun --costs` on two cells (qwen2-1.5b
    train_4k and decode_32k on the pod mesh).

The products' two differences, each in closed form (`product_gap`):
  * the causal chunk skip: the reference's `lax.cond` is averaged over its
    branches, half an attend for each of the nq·nk (q chunk, kv chunk)
    pairs; the port's loop runs A of them. An attend's two products
    (2·B·H·qc·kc·dh FLOPs each) run forward, again in the checkpointed
    repeat's recompute and twice each backward: 16·B·H·qc·kc·dh a pair;
  * the sLSTM's initial hidden state: the reference's scan transpose forms
    its cotangent through each of the 4 recurrent weights (2·B·H·dh² each);
    autograd does not, as the state is a constant (xlstm-125m: -16384 at
    both S, -0.015% of its products at S = 64).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as ref_get_config
from repro.core import table as ref_table
from repro.core import types as ref_types
from repro.launch import roofline as ref_roof
from repro.models import model as ref_model
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.core import table as port_table
from repro_torch.core import types as port_types
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as roof
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import common
from repro_torch.models import model as model_lib
from repro_torch.models.common import ParamFactory
from repro_torch.train import optim as optim_lib
from repro_torch.train import step as step_lib

ARCHS = ("qwen2-1.5b", "granite-moe-3b-a800m", "xlstm-125m",
         "jamba-v0.1-52b", "musicgen-large", "llama-3.2-vision-90b")
BATCH = 2


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- small programs ----------------------------------------------------------

def test_dot_flops_exact():
    cost = roof.step_flops(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
    assert cost.dot_flops == cost.flops == 2 * 64 * 128 * 32
    assert cost.ops == 1
    assert cost.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_loop_multiplies_body():
    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    assert roof.step_flops(f, meta(16, 16)).flops == 7 * 2 * 16 ** 3


def test_nested_loops_under_checkpoint():
    def body(c):
        for _ in range(3):
            c = c @ c
        return c

    def f(x):
        for _ in range(5):
            x = checkpoint(body, x, use_reentrant=False)
        return x
    assert roof.step_flops(f, meta(8, 8)).flops == 5 * 3 * 2 * 8 ** 3


def test_grad_counts_fwd_and_bwd():
    def loss(w, x):
        return torch.sum((x @ w) ** 2)

    def grad(w, x):
        w = w.requires_grad_(True)
        return torch.autograd.grad(loss(w, x), w)
    f_fwd = roof.step_flops(loss, meta(32, 16), meta(8, 32)).flops
    f_grad = roof.step_flops(grad, meta(32, 16), meta(8, 32)).flops
    assert f_grad >= 1.9 * f_fwd


def test_roofline_terms_and_bottleneck_with_the_cards_peaks():
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    assert "H100" in roof.CARD and "700" in roof.CARD
    r = roof.Roofline("a", "s", "pod", 256,
                      global_flops=256 * roof.PEAK_FLOPS,       # 1 s compute
                      hlo_flops_raw=0.0,
                      per_device_hbm_bytes=roof.HBM_BW / 2,     # 0.5 s memory
                      collective_bytes={"all_gather": roof.LINK_BW * 2},
                      model_flops=0.8 * 256 * roof.PEAK_FLOPS)  # 2 s coll
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert r.bottleneck == "collective"
    assert abs(r.roofline_fraction - 0.4) < 1e-9   # 0.8 useful / 2 s bound
    assert abs(r.fraction_at(4.0) - 0.2) < 1e-9
    assert r.to_dict()["bottleneck"] == "collective"
    assert roof.scan_hbm_seconds(3.35e12, 2.0, chips=2) == 1.0
    # gathers of 20 bytes in all over 4 ranks receive 60; all-to-alls of
    # 16 bytes over 4 send 12
    assert roof.link_bytes([
        {"op": "all_gather", "ranks": 4, "calls": 2, "bytes": 20},
        {"op": "all_to_all", "ranks": 4, "calls": 2, "bytes": 16}]) == \
        {"all_gather": 60, "all_to_all": 12.0}


def test_peak_tracker_to_a_hand_computed_program():
    """a (1000 float32: 4000 bytes) is the argument; b and c live
    together (12000 with a), b goes, the sum (4 bytes) is returned; a view
    and a host tensor add nothing."""
    def prog(a):
        b = a * 2
        c = b + 1
        view = c[:10]
        host = torch.ones(1000)
        del b
        return (c.sum() + view[0]) * host[0].item()
    cost = roof.step_flops(prog, meta(1000))
    mem = cost.memory
    assert mem["argument_bytes"] == 4000
    assert mem["peak_bytes"] == 3 * 4000
    assert mem["temp_bytes"] == 2 * 4000
    assert mem["output_bytes"] == 4
    assert mem["peak_by_op"] == {"arguments": 4000, "mul": 4000,
                                 "add": 4000}


# -- the train step against the reference's ---------------------------------

def product_gap(cfg, s: int, b: int) -> float:
    """Port minus reference products of a train step (the module's
    docstring)."""
    qc, kc = min(cfg.q_chunk, s), min(cfg.k_chunk, s)
    nq, nk = s // qc, s // kc
    attended = sum(min(nk, (qi * qc + qc - 1) // kc + 1) for qi in range(nq))
    n_attn = sum(spec.mixer == "attn" for spec in cfg.pattern) \
        * cfg.n_repeats
    n_slstm = sum(spec.mixer == "slstm" for spec in cfg.pattern) \
        * cfg.n_repeats
    dh_s = cfg.d_model // cfg.n_heads
    return (n_attn * (attended - nq * nk / 2) * 16 * b * cfg.n_heads * qc
            * kc * cfg.head_dim
            - n_slstm * 4 * 2 * b * cfg.n_heads * dh_s * dh_s)


def ref_step_flops(arch: str, s: int, monkeypatch) -> tuple[float, float]:
    """(total, products) of the reference's train step's jaxpr."""
    cfg = ref_get_config(arch).reduced()
    params = jax.eval_shape(lambda k: ref_model.init_params(cfg, k)[0],
                            jax.random.PRNGKey(0))
    step_cfg = ref_step.StepConfig()
    opt = jax.eval_shape(functools.partial(
        ref_optim.init_opt_state,
        cfg=step_cfg.opt_config(ref_optim.OptConfig())), params)
    tok = (BATCH, cfg.n_codebooks, s) if cfg.n_codebooks else (BATCH, s)
    batch = {k: jax.ShapeDtypeStruct(tok, jnp.int32)
             for k in ("tokens", "labels")}
    if cfg.n_vision_tokens:
        batch["vision"] = jax.ShapeDtypeStruct(
            (BATCH, cfg.n_vision_tokens, cfg.d_vision), jnp.float32)
    jaxpr = jax.make_jaxpr(ref_step.make_train_step(
        cfg, ref_optim.OptConfig(), step_cfg))(params, opt, batch)
    total = ref_roof.count_flops(jaxpr)
    for table in ("_ELEMENTWISE_1", "_ELEMENTWISE_X", "_REDUCE"):
        monkeypatch.setattr(ref_roof, table, type(getattr(ref_roof, table))())
    return total, ref_roof.count_flops(jaxpr)


def port_step_cost(arch: str, s: int) -> roof.StepCost:
    cfg = get_config(arch).reduced()
    step_cfg = step_lib.StepConfig()
    model = model_lib.DecoderLM(cfg, ParamFactory(
        None, step_cfg.param_dtype, torch.device("meta")))
    opt = optim_lib.init_opt_state(
        model.param_tree(), step_cfg.opt_config(optim_lib.OptConfig()))
    tok = (BATCH, cfg.n_codebooks, s) if cfg.n_codebooks else (BATCH, s)
    batch = {k: meta(*tok, dtype=torch.int32) for k in ("tokens", "labels")}
    if cfg.n_vision_tokens:
        batch["vision"] = meta(BATCH, cfg.n_vision_tokens, cfg.d_vision)
    step = step_lib.make_train_step(cfg, optim_lib.OptConfig(), step_cfg)
    return roof.step_flops(step, model, opt, batch)


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_equal_the_references(arch, s, monkeypatch):
    cost = port_step_cost(arch, s)
    total, dots = ref_step_flops(arch, s, monkeypatch)
    gap = product_gap(get_config(arch).reduced(), s, BATCH)
    assert cost.dot_flops - dots == gap, (cost.dot_flops, dots, gap)
    assert abs(cost.flops / total - 1.0) <= 0.15, (cost.flops, total)
    assert cost.unmapped == {}
    print(f"{arch} S={s}: products {cost.dot_flops:.6e} (reference "
          f"{dots:.6e}, gap {gap:+.0f}), total {cost.flops:.6e} "
          f"(reference {total:.6e}, {cost.flops / total - 1:+.2%})")


# -- the dry run's cells -----------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen2-1.5b", "train_4k"),
                                        ("jamba-v0.1-52b", "decode_32k")])
def test_period_extrapolation_equals_a_direct_count(arch, shape):
    mesh = production_mesh_shape(False)
    counts = {}
    for repeats in (2, 3, 4):
        cell = build_cell(arch, shape, mesh, False, repeats=repeats)
        counts[repeats] = roof.step_flops(
            cell.step, *cell.place(*cell.args_sds), comm=cell.comm)
    assert_same_cost(roof.over_repeats(counts[2], counts[3], 4), counts[4])


def assert_same_cost(got: roof.StepCost, want: roof.StepCost) -> None:
    for field in ("flops", "dot_flops", "bytes", "ops", "collective_bytes",
                  "collective_detail"):
        assert getattr(got, field) == getattr(want, field), field
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes"):
        assert got.memory[key] == want.memory[key], key


def test_sequence_extrapolation_equals_a_direct_count():
    """xlstm-125m's train step over cut sequences (the dry run's
    `cut_seq`): its backward is quadratic in the sequence (autograd sums
    each position's gradient into the whole sequence's), so three cuts
    give it; at 4 periods and 16 positions it equals a direct count."""
    mesh = production_mesh_shape(False)

    def count(repeats, seq):
        cell = build_cell("xlstm-125m", "train_4k", mesh, False,
                          repeats=repeats, seq_len=seq)
        return roof.step_flops(cell.step, *cell.place(*cell.args_sds),
                               comm=cell.comm)
    by_seq = [roof.over_repeats(count(2, s), count(3, s), 4)
              for s in (4, 8, 12)]
    assert_same_cost(roof.extrapolate(by_seq, 4), count(4, 16))
    assert dryrun.cut_seq(get_config("xlstm-125m"),
                          dryrun.SHAPES["train_4k"])


def test_the_peak_is_extrapolated_by_phase():
    """A step's peak is the largest of its phases' peaks, each linear in
    the repeats: a phase that overtakes past the cuts (here a tail
    growing by 3 units a repeat, against the repeats' 1) is found, where
    the line through the cuts' peaks misses it."""
    unit = 1000

    def step(x, repeats):
        held = []
        for _ in range(repeats):
            common.phase_boundary("repeat")
            held.append(x * 1.0)                   # a repeat's share
            peak = x.new_empty(8 * unit // 4)      # the body's temporary
            del peak
        common.phase_boundary("leaf")
        tail = x.new_empty(3 * repeats * unit // 4)
        return len(held), tail.shape
    x = meta(unit // 4)
    counts = {r: roof.step_flops(functools.partial(step, repeats=r), x)
              for r in (2, 3, 10)}
    for r, c in counts.items():
        assert c.memory["phase_kinds"] == ["start"] + ["repeat"] * r + \
            ["leaf"]
        assert c.memory["peak_bytes"] == max(c.memory["phase_peaks"])
    assert [counts[r].memory["peak_bytes"] for r in (2, 3)] == \
        [(1 + 2 + 8) * unit, (1 + 3 + 9) * unit]   # the body's, the tail's
    got = roof.over_repeats(counts[2], counts[3], 10)
    assert got.memory["peak_bytes"] == counts[10].memory["peak_bytes"] \
        == (1 + 10 + 30) * unit


def test_cell_fn_runs_on_meta_for_train_prefill_and_decode():
    mesh = production_mesh_shape(False)
    for arch, shape in (("qwen2-1.5b", "train_4k"),
                        ("qwen2-1.5b", "prefill_32k"),
                        ("xlstm-125m", "decode_32k")):
        cell = build_cell(arch, shape, mesh, False, repeats=1)
        out = cell.fn(*cell.args_sds)
        assert all(t.is_meta for t in roof._tensors(out)
                   if isinstance(t, torch.Tensor))
        assert cell.comm.bytes["all_gather"] > 0
    assert cell.comm.rank == 0 and cell.comm.world == 256


def test_dryrun_costs_on_two_cells(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    for shape in ("train_4k", "decode_32k"):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", shape, "--mesh",
                     "pod", "--costs"])
        art = json.loads((tmp_path / "pod" / f"qwen2-1.5b__{shape}.json")
                         .read_text())
        assert art["global_flops"] == art["per_rank_flops"] * 256
        mem, r = art["memory"], art["roofline"]
        assert art["fits_one_80gb_card_traced"] == \
            (mem["peak_bytes"] <= 80e9)
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        # the arguments: the placements at rest and the global batch
        tokens = 256 * (4096 if shape == "train_4k" else 1) * 4
        extra = mem["argument_bytes"] - art["per_rank_bytes"]["total"]
        assert 0 <= extra <= 2 * tokens, extra
        assert r["chips"] == 256 and r["global_flops"] == art["global_flops"]
        assert r["t_compute_s"] == pytest.approx(
            art["global_flops"] / (256 * roof.PEAK_FLOPS))
        assert r["t_memory_s"] == pytest.approx(
            art["per_rank_op_bytes"] / roof.HBM_BW)
        assert r["t_collective_s"] == pytest.approx(sum(roof.link_bytes(
            art["collective_detail"]).values()) / roof.LINK_BW)
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert art["collective_bytes"]["all_gather"] > 0
        assert (art["collective_bytes"]["all_to_all"] > 0) == \
            (shape == "train_4k")
        assert art["per_rank_flops"] > art["per_rank_dot_flops"] > 0
    out = capsys.readouterr().out
    assert out.count("  costs: flops") == 2
    assert out.count("dry-run cells placed OK, their steps counted.") == 2


# -- the engine's small API --------------------------------------------------

def test_max_rel_err_equals_the_references():
    rows = [(10.0, 1.0, False), (0.0, 2.0, False), (-4.0, 1.0, False),
            (5.0, 100.0, True)]
    for groups in (rows, rows[3:], []):
        answers = []
        for types in (ref_types, port_types):
            answers.append(types.Answer(
                None, [types.GroupResult((i,), e, s, e - s, e + s, 1.0, x)
                       for i, (e, s, x) in enumerate(groups)],
                (), 1.0, 1, 1, 0.0, 0.95).max_rel_err)
        assert answers[0] == answers[1]
    assert answers[0] == 0.0


def test_column_codes_equal_the_references():
    rng = np.random.default_rng(0)
    raw = {"OS": rng.choice(np.array(["a", "b", "c"]), 50),
           "t": rng.random(50).astype(np.float32)}
    want = ref_table.from_columns("s", raw)
    got = port_table.from_columns("s", raw).to("cpu")
    for col in raw:
        np.testing.assert_array_equal(got.column_codes(col).numpy(),
                                      np.asarray(want.column_codes(col)))
    assert got.column_codes("OS").dtype == torch.int32
