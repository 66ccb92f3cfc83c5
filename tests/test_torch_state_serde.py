"""State serde of the port against the JAX package's
(analyzers/state_provider.py in each): for every state family the port
writes the JAX package's bytes, and each package reads the other's bytes
back to the same state.

The states come from one seeded table folded by each package's fused
pass (the JAX side on its device placement). Tolerances: the bytes of
order-insensitive states (counts, minima, maxima, HLL registers, KLL
sketches, data-type histograms, frequencies) are equal. States folded as
float sums (Sum, Mean, StandardDeviation, Correlation) differ in the last
bits where torch and XLA add in other orders: their decoded fields agree
within 1e-12 relative, and on a column of small dyadic values, whose sums
are exact in any order, the bytes of Sum, Mean and StandardDeviation are
equal too (Correlation's fields are running means and co-moments, which
divide and so stay order-dependent). A state read back in
either package re-serializes to the same bytes.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu.analyzers import state_provider as jsp
from deequ_tpu.analyzers.freq_spill import GroupCountAccumulator as JAccumulator
from deequ_tpu.analyzers.frequency import compute_frequencies as j_compute_frequencies
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu_torch.analyzers import state_provider as psp
from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator as PAccumulator
from deequ_tpu_torch.analyzers.frequency import compute_frequencies as p_compute_frequencies
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass

N = 3000

ORDER_INSENSITIVE = [
    ("Size", ()),
    ("Completeness", ("x",)),
    ("Compliance", ("positive", "x > 0")),
    ("PatternMatch", ("s", r"^\d+$")),
    ("Minimum", ("x",)),
    ("Maximum", ("x",)),
    ("DataType", ("s",)),
    ("ApproxCountDistinct", ("id",)),
    ("ApproxCountDistinct", ("s",)),
    ("ApproxQuantile", ("x", 0.5)),
    ("ApproxQuantiles", ("x", [0.1, 0.5, 0.9])),
]
FLOAT_SUMS = [
    ("Sum", ("x",)),
    ("Mean", ("x",)),
    ("StandardDeviation", ("x",)),
    ("Correlation", ("x", "y")),
]


def _columns(seed: int = 7, dyadic: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    if dyadic:
        # multiples of 1/8 below 2^10: every partial sum of 3000 of them,
        # and of their squares, is exact in float64
        x = rng.integers(-4096, 4096, N) / 8.0
        y = rng.integers(-4096, 4096, N) / 8.0
    else:
        x = rng.normal(3.0, 2.0, N)
        y = 0.5 * x + rng.normal(0.0, 1.0, N)
    x[::13] = np.nan
    s = np.array(
        [["42", "word", "3.14", None, "true", "7"][i] for i in rng.integers(0, 6, N)],
        dtype=object,
    )
    return {"x": x, "y": y, "id": rng.integers(0, N, N), "s": s}


def _states(name, args, cols, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    ja, pa = getattr(J, name)(*args), getattr(P, name)(*args)
    jstate = JPass([ja]).run(JTable.from_numpy(cols))[0].state_or_raise()
    pstate = PPass([pa], device="cpu").run(PTable.from_numpy(cols))[0].state_or_raise()
    return ja, pa, jstate, pstate


def _cross_read(ja, pa, jbytes, pbytes):
    """Each package reads the other's bytes back to a state that
    re-serializes to those bytes."""
    from_port = jsp.deserialize_state(ja, pbytes)
    assert jsp.serialize_state(ja, from_port) == pbytes
    from_jax = psp.deserialize_state(pa, jbytes)
    assert psp.serialize_state(pa, from_jax) == jbytes


@pytest.mark.parametrize(
    "name,args", ORDER_INSENSITIVE, ids=[f"{n}{a[:1]}" for n, a in ORDER_INSENSITIVE]
)
def test_order_insensitive_state_bytes_equal(monkeypatch, name, args):
    ja, pa, jstate, pstate = _states(name, args, _columns(), monkeypatch)
    jbytes, pbytes = jsp.serialize_state(ja, jstate), psp.serialize_state(pa, pstate)
    assert pbytes == jbytes
    _cross_read(ja, pa, jbytes, pbytes)


@pytest.mark.parametrize("name,args", FLOAT_SUMS, ids=[n for n, _ in FLOAT_SUMS])
def test_float_sum_states_agree(monkeypatch, name, args):
    ja, pa, jstate, pstate = _states(name, args, _columns(), monkeypatch)
    jbytes, pbytes = jsp.serialize_state(ja, jstate), psp.serialize_state(pa, pstate)
    assert len(pbytes) == len(jbytes)
    fmt = {"Sum": ">d", "Mean": ">dq", "StandardDeviation": ">ddd", "Correlation": ">dddddd"}[name]
    for p, j in zip(struct.unpack(fmt, pbytes), struct.unpack(fmt, jbytes)):
        assert p == pytest.approx(j, rel=1e-12, abs=1e-300)
    _cross_read(ja, pa, jbytes, pbytes)


@pytest.mark.parametrize("name,args", FLOAT_SUMS[:3], ids=[n for n, _ in FLOAT_SUMS[:3]])
def test_float_sum_state_bytes_equal_on_exact_sums(monkeypatch, name, args):
    ja, pa, jstate, pstate = _states(name, args, _columns(dyadic=True), monkeypatch)
    assert psp.serialize_state(pa, pstate) == jsp.serialize_state(ja, jstate)


def _frequency_states(columns, max_groups):
    cols = _columns()
    jt, pt = JTable.from_numpy(cols), PTable.from_numpy(cols)
    if max_groups is None:
        return j_compute_frequencies(jt, columns), p_compute_frequencies(pt, columns)
    # fold in four slices through the group-cap accumulator: past the
    # cap both spill to hash partitions on disk
    jacc, pacc = JAccumulator(columns, max_groups), PAccumulator(columns, max_groups)
    for lo in range(0, N, N // 4):
        part = {k: v[lo : lo + N // 4] for k, v in cols.items()}
        jacc.add(j_compute_frequencies(JTable.from_numpy(part), columns))
        pacc.add(p_compute_frequencies(PTable.from_numpy(part), columns))
    return jacc.finalize(), pacc.finalize()


@pytest.mark.parametrize("max_groups", [None, 4], ids=["in_memory", "spilled"])
@pytest.mark.parametrize("columns", [["id"], ["s"], ["id", "s"]], ids=["id", "s", "id_s"])
def test_frequency_state_bytes_equal(columns, max_groups):
    jstate, pstate = _frequency_states(columns, max_groups)
    assert getattr(pstate, "is_spilled", False) == (max_groups is not None)
    assert getattr(jstate, "is_spilled", False) == (max_groups is not None)
    ja, pa = J.CountDistinct(columns), P.CountDistinct(columns)
    jbytes, pbytes = jsp.serialize_state(ja, jstate), psp.serialize_state(pa, pstate)
    assert pbytes == jbytes
    from_jax = psp.deserialize_state(pa, jbytes)
    assert pa.compute_metric_from(from_jax).value.get() == ja.compute_metric_from(
        jstate
    ).value.get()
    from_port = jsp.deserialize_state(ja, pbytes)
    assert ja.compute_metric_from(from_port).value.get() == pa.compute_metric_from(
        pstate
    ).value.get()


def test_hll_words_equal_the_jax_packing():
    rng = np.random.default_rng(3)
    registers = rng.integers(0, 64, 512).astype(np.int32)
    from deequ_tpu.ops.sketches import hll as jhll
    from deequ_tpu_torch.ops.sketches import hll as phll

    words = phll.pack_words(registers)
    assert np.array_equal(words, jhll.pack_words(registers))
    assert np.array_equal(phll.unpack_words(words), registers)
    regs = np.zeros(512, dtype=np.int32)
    idx = rng.integers(0, 512, 200)
    rank = rng.integers(1, 40, 200).astype(np.int32)
    assert np.array_equal(
        phll.update_registers(regs.copy(), idx, rank), jhll.update_registers(regs.copy(), idx, rank)
    )


def test_kll_rng_state_round_trips():
    from deequ_tpu_torch.ops.sketches.kll import KLLSketch

    sketch = KLLSketch(k=64)
    sketch.update_batch(np.arange(1000, dtype=np.float64))
    blob = sketch.rng_state_bytes()
    assert len(blob) == KLLSketch.RNG_STATE_LEN
    other = KLLSketch(k=64, seed=99)
    other.set_rng_state_bytes(blob)
    assert other.rng_state_bytes() == blob
    with pytest.raises(ValueError):
        other.set_rng_state_bytes(blob[:-1])
