"""The port's fused pass around the kernels: wire format, plan cache,
placement and device resolution."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deequ_tpu_torch.ops import fused, runtime

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 7, 8, 13, 1024 + 37])
def test_bits_round_trip_in_packbits_order(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.5
    mask[0] = False  # never all-true: must ship as bits
    padded = runtime.wire_pad_size(n)
    host, layout = fused.pack_batch_inputs([("valid:x", mask)], padded, {}, n)
    assert layout[0] == (("uint8:bits", (("valid:x", "bits"),)),)
    inputs = fused.FusedProgram([], layout, CPU).unpack(host, n)
    got = inputs["valid:x"].numpy()
    assert got.shape == (padded,)
    np.testing.assert_array_equal(got[:n], mask)
    assert not got[n:].any()  # padded rows carry a false mask


def test_all_true_mask_is_rebuilt_from_the_row_count_until_a_batch_has_a_null():
    sticky = {}
    n = 13
    host, layout = fused.pack_batch_inputs([("valid:x", np.ones(n, bool))], 16, sticky, n)
    assert host == {} and layout[1] == ("valid:x",)
    inputs = fused.FusedProgram([], layout, CPU).unpack(host, n)
    np.testing.assert_array_equal(inputs["valid:x"].numpy(), np.arange(16) < n)
    mask = np.ones(n, bool)
    mask[3] = False
    _host, layout = fused.pack_batch_inputs([("valid:x", mask)], 16, sticky, n)
    assert layout[1] == ()
    # once bits, always bits for the pass: an all-true batch ships bits too
    _host, layout = fused.pack_batch_inputs([("valid:x", np.ones(n, bool))], 16, sticky, n)
    assert layout[1] == () and layout[0][0][0] == "uint8:bits"


def test_ints_narrow_on_the_wire_and_widen_exactly():
    codes = np.array([0, 1, (511 << 6) | 56, 77], dtype=np.int32)
    sticky = {}
    host, layout = fused.pack_batch_inputs([("hll:id", codes)], 8, sticky, 4)
    assert layout[0][0][0] == "int16:int"
    inputs = fused.FusedProgram([], layout, CPU).unpack(host, 4)
    assert inputs["hll:id"].dtype == torch.int32
    np.testing.assert_array_equal(inputs["hll:id"].numpy()[:4], codes)
    # the pinned width never narrows again within a pass
    _host, layout = fused.pack_batch_inputs([("hll:id", codes[:2])], 8, sticky, 2)
    assert layout[0][0][0] == "int16:int"


def test_values_ship_as_float64_with_zero_padding():
    x = np.array([1.5, -2.0, 3.25])
    host, layout = fused.pack_batch_inputs([("num:x", x)], 8, {}, 3)
    inputs = fused.FusedProgram([], layout, CPU).unpack(host, 3)
    np.testing.assert_array_equal(inputs["num:x"].numpy(), [1.5, -2.0, 3.25, 0, 0, 0, 0, 0])


def test_plan_cache_keys_on_analyzers_and_layout():
    from deequ_tpu_torch.analyzers import Mean, Size

    layout = ((), ("where:<all>",), 8)
    a = fused.get_fused_fn([Size()], layout, CPU)
    assert fused.get_fused_fn([Size()], layout, CPU) is a
    assert fused.get_fused_fn([Size(), Mean("x")], layout, CPU) is not a
    assert fused.get_fused_fn([Size()], ((), ("where:<all>",), 16), CPU) is not a


def test_outputs_round_trip_through_one_buffer():
    outs = [
        {"n": torch.tensor(5)},
        {"registers": torch.arange(512, dtype=torch.int32), "m2": torch.tensor(2.5, dtype=torch.float64)},
    ]
    flat, meta = fused.pack_outputs(outs, CPU)
    assert flat.dtype == torch.float64 and flat.shape == (514,)
    back = fused.unpack_outputs(flat.numpy(), meta, 2)
    assert back[0]["n"] == 5.0
    np.testing.assert_array_equal(back[1]["registers"], np.arange(512))
    assert back[1]["m2"] == 2.5


@pytest.mark.parametrize(
    "env,expect",
    [(None, "device"), ("auto", "device"), ("device", "device"),
     ("host", NotImplementedError), ("host-all", NotImplementedError),
     ("host-discrete", NotImplementedError), ("bogus", ValueError)],
)
def test_placement_mode(monkeypatch, env, expect):
    if env is None:
        monkeypatch.delenv("DEEQU_TPU_PLACEMENT", raising=False)
    else:
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", env)
    if isinstance(expect, str):
        assert runtime.placement_mode() == expect
    else:
        with pytest.raises(expect):
            runtime.placement_mode()


def test_device_resolution(monkeypatch):
    assert runtime.resolve_device("cpu") == CPU
    assert runtime.fold_variant(CPU) == ""
    assert runtime.fold_variant(torch.device("cuda", 0)) == "cuda-folds"
    assert runtime.compute_dtype() == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError):
            runtime.resolve_device(device)
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")


def test_wire_pad_size():
    assert [runtime.wire_pad_size(n) for n in (0, 1, 8, 9, 1 << 22)] == [8, 8, 8, 16, 1 << 22]
