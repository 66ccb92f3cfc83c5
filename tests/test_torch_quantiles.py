"""ApproxQuantile(s): the port's hist16 route on device="cpu" against the
JAX package's float64 sort route (FusedScanPass with device placement).

Both select the same decimated sample per batch, so the per-batch seeds,
the KLL levels and every quantile must be EQUAL — compared bit for bit.
Batch boundaries decide the sketch, so both passes get the same explicit
batch_size."""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu.analyzers.sketch import ApproxQuantile as JQ
from deequ_tpu.analyzers.sketch import ApproxQuantiles as JQS
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu_torch.analyzers.sketch import ApproxQuantile as PQ
from deequ_tpu_torch.analyzers.sketch import ApproxQuantiles as PQS
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import cuda_kernels as ck
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner

QS = (0.1, 0.25, 0.5, 0.9)


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def data(n_rows=6000, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n_rows)
    x[::13] = np.nan
    return {
        "x": x,
        "g": rng.integers(0, 4, n_rows),
        "nulls": np.full(n_rows, np.nan),
    }


def run_both(jan, pan, cols, batch_size):
    jstates = [
        r.state_or_raise()
        for r in JPass(jan, batch_size=batch_size).run(JTable.from_numpy(cols))
    ]
    pstates = [
        r.state_or_raise()
        for r in PPass(pan, batch_size=batch_size, device="cpu").run(PTable.from_numpy(cols))
    ]
    return jstates, pstates


def assert_same_sketch(jstate, pstate):
    k1, n1, l1 = jstate.digest.to_arrays()
    k2, n2, l2 = pstate.digest.to_arrays()
    assert (k1, n1, len(l1)) == (k2, n2, len(l2))
    for a, b in zip(l1, l2):
        assert a.tobytes() == b.tobytes()


def assert_same_metric(jan, pan, jstate, pstate):
    jm, pm = jan.compute_metric_from(jstate), pan.compute_metric_from(pstate)
    assert repr(jan) == repr(pan)
    assert pm.value.is_success == jm.value.is_success
    if jm.value.is_success:
        jv, pv = jm.value.get(), pm.value.get()
        if isinstance(jv, dict):
            assert list(pv) == list(jv)
            assert [np.float64(v).tobytes() for v in pv.values()] == [
                np.float64(v).tobytes() for v in jv.values()
            ]
        else:
            assert np.float64(pv).tobytes() == np.float64(jv).tobytes()
    else:
        assert str(pm.value.exception) == str(jm.value.exception)


@pytest.mark.parametrize("relative_error", [0.01, 0.1])
@pytest.mark.parametrize("batch_size", [6000, 1500, 1700], ids=["one", "four", "ragged"])
def test_quantiles_equal_jax(relative_error, batch_size):
    cols = data()
    jan = [JQ("x", 0.5, relative_error), JQS("x", QS, relative_error)]
    pan = [PQ("x", 0.5, relative_error), PQS("x", QS, relative_error)]
    jstates, pstates = run_both(jan, pan, cols, batch_size)
    for ja, pa, js, ps in zip(jan, pan, jstates, pstates):
        assert_same_sketch(js, ps)
        assert_same_metric(ja, pa, js, ps)


@pytest.mark.parametrize("relative_error", [0.01, 0.1])
def test_quantile_with_where(relative_error):
    cols = data()
    jan = [JQ("x", 0.75, relative_error, where="g >= 2")]
    pan = [PQ("x", 0.75, relative_error, where="g >= 2")]
    jstates, pstates = run_both(jan, pan, cols, batch_size=2000)
    assert_same_sketch(jstates[0], pstates[0])
    assert_same_metric(jan[0], pan[0], jstates[0], pstates[0])


def test_all_null_column_gives_the_failure_metric():
    cols = data()
    jan = [JQ("nulls", 0.5), JQS("nulls", QS)]
    pan = [PQ("nulls", 0.5), PQS("nulls", QS)]
    jstates, pstates = run_both(jan, pan, cols, batch_size=2000)
    assert pstates == [None, None] and jstates == [None, None]
    for ja, pa in zip(jan, pan):
        assert_same_metric(ja, pa, None, None)


def test_signed_zeros_keep_the_sample_bytes():
    """-0.0 and +0.0 land in adjacent bins; the host takes both bins and
    sorts stably, so zeros keep row order as the JAX package's stable
    float64 sort does — the sample bytes, and with them the batch seeds,
    agree."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.array([-0.0, 0.0, -1.0, 1.0]), 6000)
    cols = {"x": x}
    for relative_error in (0.01, 0.1):
        jan, pan = [JQS("x", QS, relative_error)], [PQS("x", QS, relative_error)]
        jstates, pstates = run_both(jan, pan, cols, batch_size=2000)
        assert_same_sketch(jstates[0], pstates[0])
        assert_same_metric(jan[0], pan[0], jstates[0], pstates[0])


def test_subnormals_order_by_value_unlike_the_jax_cpu_sort():
    """A known difference of the reference, not of the port: XLA on the
    CPU treats float64 subnormals as zero when it compares, so the JAX
    package's sort leaves them among the zeros in row order. The port
    orders them by value (they share the zeros' float32 bins and sort in
    float64), so a column of them gives other samples."""
    import jax.numpy as jnp

    x = np.array([1e-310, -0.0, -1e-310, 0.0, 2e-310, -5.0])
    assert np.asarray(jnp.sort(jnp.asarray(x))).tolist() == [
        -5.0, 1e-310, -0.0, -1e-310, 0.0, 2e-310
    ]
    state = PPass([PQS("x", (0.0, 0.2, 1.0))], device="cpu").run(
        PTable.from_numpy({"x": x})
    )[0].state_or_raise()
    assert state.digest.to_arrays()[2][0].tolist() == [-5.0, -1e-310, -0.0, 0.0, 1e-310, 2e-310]


def test_overflow_to_infinity_sorts_within_its_bin():
    """Finite float64 values beyond the float32 range cast to +-inf and
    share the infinities' bins; the float64 sort inside the bin orders
    them."""
    rng = np.random.default_rng(9)
    x = rng.choice(np.array([np.inf, -np.inf, 1e300, -1e300, 1e39, -1e39, 7.0]), 5000)
    cols = {"x": x}
    jan = [JQS("x", (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0), 0.1)]
    pan = [PQS("x", (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0), 0.1)]
    jstates, pstates = run_both(jan, pan, cols, batch_size=5000)
    assert_same_sketch(jstates[0], pstates[0])
    assert_same_metric(jan[0], pan[0], jstates[0], pstates[0])
    got = pan[0].compute_metric_from(pstates[0]).value.get()
    assert got["0.0"] == -np.inf and got["1.0"] == np.inf


def test_quantile_within_rank_error_of_exact():
    cols = data(20000, seed=4)
    x = cols["x"][~np.isnan(cols["x"])]
    state = PPass([PQS("x", QS, 0.01)], batch_size=5000, device="cpu").run(
        PTable.from_numpy(cols)
    )[0].state_or_raise()
    got = PQS("x", QS, 0.01).compute_metric_from(state).value.get()
    ordered = np.sort(x)
    for q in QS:
        rank = np.searchsorted(ordered, got[repr(q)])
        assert abs(rank - q * len(x)) <= 0.01 * len(x)


@pytest.mark.parametrize(
    "analyzer,message",
    [
        (PQ("x", 1.5), "Quantile parameter must be in the closed interval [0, 1]"),
        (PQ("x", 0.5, -0.1), "Relative error parameter must be in the closed interval"),
        (PQS("x", (0.5, -1.0)), "Quantile parameter must be in the closed interval [0, 1]"),
        (PQ("missing", 0.5), "Input data does not include column missing!"),
    ],
)
def test_bad_parameters_fail_the_metric(analyzer, message):
    ctx = PRunner.do_analysis_run(PTable.from_numpy(data(100)), [analyzer], device="cpu")
    metric = ctx.metric(analyzer)
    assert metric.value.is_failure and message in str(metric.value.exception)


def test_cpu_run_launches_no_kernel():
    ck.reset_launch_counts()
    PPass([PQ("x", 0.5), PQS("x", QS)], batch_size=2000, device="cpu").run(
        PTable.from_numpy(data())
    )
    assert ck.launch_counts()["hist16"] == 0
