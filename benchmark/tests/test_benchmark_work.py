"""The work counts (benchmark/work) at small shapes against hand counts,
and the Taylor pre-pass against the port's front end."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.work import column_batch, gate, state_transfer, taylor

SIZES = {"M": 4, "K": 1, "E": 0, "T": 2, "V": 1, "terms": 3,
         "squarings": 1, "reg_coeffs": {}}


def test_gate_by_hand():
    # K' = 2; propagation min(2*64*(2+1) + 2*16, 2*16*1*2*2) = 128
    # step 2*2*16 + 2*128 + 2*2*16 = 384; 2 steps, loss 8*4, Adam 16*2
    assert gate.per_seed(SIZES) == {"flops": 832, "shared_bytes": 128,
                                    "seed_bytes": 80}


def test_gate_takes_the_matrix_form_where_it_is_cheaper():
    # M 2, V 2, 3 terms, 3 squarings: matrix 2*8*5 + 2*4*2 = 96 against
    # columns 2*4*2*2*8 = 256; step 16 + 192 + 16, one step, loss 32,
    # Adam 16
    s = dict(SIZES, M=2, V=2, T=1, squarings=3)
    assert gate.per_seed(s)["flops"] == 272


def test_state_transfer_by_hand():
    # no squaring: columns 2*16*1*2 = 64; step 64 + 128 + 64 = 256
    assert state_transfer.per_seed(SIZES)["flops"] == 576


def test_costs_by_hand():
    s = dict(SIZES, reg_coeffs={"forbidden_coeff_list": [1.0, 1.0],
                                "states_forbidden_list": [2, 3],
                                "dwdt": 0.1})
    # forbidden 2*6*2 levels*1*3, dwdt 2*6*1*2
    assert gate.per_seed(s)["flops"] == 832 + 72 + 24


@pytest.mark.parametrize("cost,flops", [
    # envelope 2*3*K*T; bandpass 2*5*K*T*log2(T); speed_up 2*8*M*V*(T+1)
    ({"envelope": 0.1}, 12),
    ({"bandpass": 0.1, "band": [0.1, 10.0]}, 20),
    ({"speed_up": 0.1}, 192)], ids=["envelope", "bandpass", "speed_up"])
def test_the_queued_costs_by_hand(cost, flops):
    s = dict(SIZES, reg_coeffs=cost)
    assert gate.per_seed(s)["flops"] == 832 + flops
    assert state_transfer.per_seed(s)["flops"] == 576 + flops


def test_bandpass_counts_log2_of_the_steps():
    s = dict(SIZES, T=1000, reg_coeffs={"bandpass": 0.1, "band": [0, 1]})
    bare = gate.per_seed(dict(s, reg_coeffs={}))["flops"]
    assert gate.per_seed(s)["flops"] - bare == pytest.approx(
        10 * 1000 * np.log2(1000))


def test_an_unknown_cost_has_no_count():
    with pytest.raises(NotImplementedError):
        gate.per_seed(dict(SIZES, reg_coeffs={"d2wdt2": 0.1}))


def test_column_batch_shares_the_generators():
    w = column_batch.per_iteration("gate", SIZES, 3)
    assert w == {"flops": 3 * 832, "bytes": 128 + 3 * 80}


@pytest.mark.parametrize("name", ["transmon_leakage", "multimode_cavity"])
def test_taylor_prepass_is_the_front_ends(name):
    from qoc_tpu_torch.ops.taylor import choose_taylor_terms

    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    s = harness.load_module(harness.HERE / "configs" / f"{name}.py",
                            "cfg_" + name).build(cfg)
    dt = s["total_time"] / s["steps"]
    mine = taylor.taylor_terms(s["H0"], s["Hops"], s["maxA"], dt,
                               s["steps"], s["state_transfer"])
    theirs = choose_taylor_terms(
        s["H0"], s["Hops"], np.asarray(s["maxA"]), np.eye(len(s["H0"])), dt,
        s["steps"], 1e-4, s["state_transfer"], False)
    assert mine == theirs
