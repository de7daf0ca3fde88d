"""Port parity: synthetic data, tables, sample families and striping.

The same seeded inputs go through the JAX package (`repro`) and the port
(`repro_torch`); sample families are built from the reference's carried
per-row units (repro_torch.state), so every array must match exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import executor as ref_exec
from repro.core import sampling as ref_samp
from repro.core import table as ref_table
from repro.data import synth as ref_synth
from repro_torch.core import executor as exec_lib
from repro_torch.core import sampling as samp_lib
from repro_torch.core import table as table_lib
from repro_torch.data import synth

N_ROWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables():
    ref = ref_table.from_columns("sessions",
                                 ref_synth.sessions_table(N_ROWS, seed=3))
    port = table_lib.from_columns("sessions",
                                  synth.sessions_table(N_ROWS, seed=3))
    return ref, port


@pytest.mark.parametrize("maker, kw", [
    ("sessions_table", {"n_rows": 5000, "seed": 3}),
    ("sessions_table", {"n_rows": 777, "seed": 11, "n_cities": 1000}),
    ("lineitem_table", {"n_rows": 5000, "seed": 1}),
])
def test_synth_tables_identical(maker, kw):
    want = getattr(ref_synth, maker)(**kw)
    got = getattr(synth, maker)(**kw)
    assert list(got) == list(want)
    for col in want:
        assert got[col].dtype == want[col].dtype, col
        np.testing.assert_array_equal(got[col], want[col], err_msg=col)


def test_label_of_empty_codes_matches():
    want = ref_synth._label("x", np.zeros(0, np.int32))
    got = synth._label("x", np.zeros(0, np.int32))
    assert got.dtype == want.dtype and got.shape == want.shape


def test_from_columns_dictionaries_and_codes(tables):
    ref, port = tables
    assert port.n_rows == ref.n_rows
    assert [(c.name, c.kind.value, c.cardinality) for c in port.schema.columns] \
        == [(c.name, c.kind.value, c.cardinality) for c in ref.schema.columns]
    for col in ref.schema.column_names:
        np.testing.assert_array_equal(port.host_column(col),
                                      ref.host_column(col), err_msg=col)
        assert port.host_column(col).dtype == ref.host_column(col).dtype
    for col, d in ref.dictionaries.items():
        np.testing.assert_array_equal(port.dictionaries[col], d)
    for col, value in (("City", "city007"), ("OS", "os3"), ("dt", 15),
                       ("URL", "nope")):
        assert port.encode_value(col, value) == ref.encode_value(col, value)
    assert port.decode_value("OS", 2) == ref.decode_value("OS", 2)


@pytest.mark.parametrize("phi", [(), ("OS",), ("City", "OS"),
                                 ("Genre", "URL", "dt"), ("City", "URL")])
def test_combined_codes_identical(tables, phi):
    ref, port = tables
    want_codes, want_keys = ref_table.combined_codes(ref, phi)
    got_codes, got_keys = table_lib.combined_codes(port, phi)
    np.testing.assert_array_equal(got_codes, want_codes.reshape(-1))
    np.testing.assert_array_equal(got_keys, want_keys)
    assert got_codes.dtype == np.int64 and got_keys.dtype == np.int32


def test_table_to_device_uploads_columns(tables):
    _, port = tables
    port.to("cpu")
    assert port.device == torch.device("cpu")
    for col in port.schema.column_names:
        np.testing.assert_array_equal(port.columns[col].numpy(),
                                      port.host_column(col))


def _families(ref, port, phi, **kw):
    if phi:
        units = ref_samp.base_units(ref.n_rows, 5)
        want = ref_samp.build_family(ref, phi, units=units, **kw)
        got = samp_lib.build_family(port, phi, units=units, **kw)
    else:
        units = ref_samp.base_units(ref.n_rows, 5, uniform=True)
        want = ref_samp.build_uniform_family(ref, 0.3, units=units, **kw)
        got = samp_lib.build_uniform_family(port, 0.3, units=units, **kw)
    return want, got


@pytest.mark.parametrize("phi, kw", [
    (("OS",), {"k1": 800.0, "m": 3}),
    (("City",), {"k1": 300.0}),
    (("City", "Genre"), {"k1": 50.0, "c": 3.0, "m": 4}),
    ((), {"m": 5}),
])
def test_families_from_carried_units_identical(tables, phi, kw):
    ref, port = tables
    want, got = _families(ref, port, phi, **kw)
    assert got.phi == want.phi and got.ks == want.ks
    assert got.prefix_sizes == want.prefix_sizes
    assert (got.n_rows, got.table_rows, got.n_distinct) == \
        (want.n_rows, want.table_rows, want.n_distinct)
    for name in ("row_ids", "row_strata", "unit_host", "stratum_freqs",
                 "entry_key_host", "strata_keys"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for col in want.columns_host:
        np.testing.assert_array_equal(got.columns_host[col],
                                      want.columns_host[col], err_msg=col)
    for k in want.ks + (want.ks[-1] / 3.0, 1e9):
        assert got.prefix_for_k(k) == want.prefix_for_k(k)


@pytest.mark.parametrize("phi", [("OS",), ("City", "Genre"), ()])
def test_stripe_family_identical(tables, phi):
    ref, port = tables
    want_fam, got_fam = _families(ref, port, phi, k1=400.0, m=3)
    want = ref_exec.stripe_family(want_fam, 1)
    got = exec_lib.stripe_family(got_fam, device="cpu")
    assert got.n_rows == want.n_rows and got.n_local == want.n_local
    assert got.table_rows == want.table_rows

    def same(g, w, name):
        w = np.asarray(w)
        assert str(g.numpy().dtype) == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    assert sorted(got.columns) == sorted(want.columns)
    for col in want.columns:
        same(got.columns[col], want.columns[col][0], col)
    same(got.valid, want.valid[0], "valid")
    same(got.unit, want.unit[0], "unit")
    same(got.strat, want.strat[0], "strat")
    same(got.freq_table, want.freq_table, "freq_table")


def test_port_base_units_seeded_and_in_range():
    a = samp_lib.base_units(10_000, 4)
    b = samp_lib.base_units(10_000, 4)
    u = samp_lib.base_units(10_000, 4, uniform=True)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, u)
    assert a.dtype == np.float32
    assert a.min() >= np.float32(1e-7) and a.max() < 1.0
