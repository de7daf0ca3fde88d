"""The port's copy of the LM configs (`repro_torch.configs`) equals the
reference's (`repro.configs`) for every architecture: fields, parameter
counts, the reduced smoke configs and the assigned shape cells."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro_torch import configs as port_configs
from repro_torch.configs import base as port_base

ARCHS = ref_configs.all_archs()


def test_registry_is_the_reference_registry():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.all_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_match(arch):
    ref, port = ref_configs.get_config(arch), port_configs.get_config(arch)
    assert isinstance(port, port_base.ModelConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_dim == ref.head_dim
    assert port.n_repeats == ref.n_repeats
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port_base.shapes_for(port) == ref_base.shapes_for(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches(arch):
    ref = ref_configs.get_config(arch).reduced()
    port = port_configs.get_config(arch).reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_shapes_table_matches():
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    assert port_base.dense_pattern() == tuple(
        port_base.LayerSpec(s.mixer, s.channel)
        for s in ref_base.dense_pattern())
    assert port_base.moe_pattern() == tuple(
        port_base.LayerSpec(s.mixer, s.channel)
        for s in ref_base.moe_pattern())


def test_unknown_arch_raises_the_same_key_error():
    with pytest.raises(KeyError) as ref_err:
        ref_configs.get_config("gpt-5")
    with pytest.raises(KeyError) as port_err:
        port_configs.get_config("gpt-5")
    assert str(port_err.value) == str(ref_err.value)


def test_qwen2_is_the_published_width():
    cfg = port_configs.get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 1536, 12, 2, 128, 8960, 151_936)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.rope_theta == 1_000_000.0
    assert 1.5e9 < cfg.param_count() < 1.6e9
