"""The penalty registry (port of ``qoc_tpu.models.costs``).

Every penalty is a plain torch function ``f(ctx, reg_coeffs) -> scalar``
registered by name; the regularized loss is the fidelity loss plus the
sum of the selected penalties (regularization_functions.py:7-97).
Autograd differentiates them, so the plain engines and the plain segment
(``ops.mega.mega_segment_reference``) share this one definition; the CUDA
segment kernel computes the same penalties and their analytic gradients
in-kernel.

Semantics kept from qoc_tpu (and the reference):
  * l2(x) = 0.5 * sum(x^2)  (tf.nn.l2_loss).
  * The penalties act on the normalized weights sin(base) in [-1, 1], not
    on the physical amplitudes (regularization_functions.py:18,25,30,41,55).
  * ``dwdt``/``d2wdt2`` pad two zeros on each side of the pulse.
  * ``bandpass`` sums |FFT| (complex64 for float32 pulses) over the bins
    [0, band0*total_time) and [band1*total_time, steps/2).
  * ``forbidden_coeff_list`` (alias ``forbidden``) and ``speed_up`` read
    the intermediate states [T+1, 2N, V], whose entry 0 is the RAW psi0;
    they raise when the forward kept none (use_inter_vecs=False).
"""

from __future__ import annotations

import difflib
from typing import Callable, Dict

import numpy as np
import torch

from ..ops.inner_products import inner_product_3d


def _l2(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(torch.square(x))


class CostContext:
    """Bag of tensors the cost functions may read.

    Attributes:
      ops_weight:       [K, T] normalized weights sin(base).
      inter_vecs:       [T+1, 2N, V] intermediate states (or None).
      target_vecs:      [2N, V].
      state_num:        N (complex dimension).
      steps, dt, total_time: horizon parameters.
      one_minus_gauss:  [K, T] envelope mask (system_parameters.py:253-266).
      v_sorted_iso:     [2N, 2N] dressed rotation (real iso) or None.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


CostFn = Callable[[CostContext, dict], torch.Tensor]
REGISTRY: Dict[str, CostFn] = {}


def register(name: str):
    def deco(fn: CostFn) -> CostFn:
        REGISTRY[name] = fn
        return fn

    return deco


@register("amplitude")
def amplitude_cost(ctx, reg_coeffs):
    """coeff/steps * l2(ops_weight) (regularization_functions.py:15-18)."""
    alpha = reg_coeffs["amplitude"] / float(ctx.steps)
    return alpha * _l2(ctx.ops_weight)


@register("envelope")
def envelope_cost(ctx, reg_coeffs):
    """Weight outside a Gaussian envelope (regularization_functions.py:21-25)."""
    alpha = reg_coeffs["envelope"] / float(ctx.steps)
    return alpha * _l2(ctx.one_minus_gauss * ctx.ops_weight)


def _padded_weights(ctx):
    """[zeros(2), w, zeros(2)] along time (regularization_functions.py:29-31)."""
    return torch.nn.functional.pad(ctx.ops_weight, (2, 2))


@register("dwdt")
def dwdt_cost(ctx, reg_coeffs):
    """First finite difference of the padded pulse
    (regularization_functions.py:28-35)."""
    alpha = reg_coeffs["dwdt"] / float(ctx.steps)
    w = _padded_weights(ctx)
    return alpha * _l2((w[:, 1:] - w[:, : ctx.steps + 3]) / ctx.dt)


@register("d2wdt2")
def d2wdt2_cost(ctx, reg_coeffs):
    """Second finite difference (regularization_functions.py:38-45)."""
    alpha = reg_coeffs["d2wdt2"] / float(ctx.steps)
    w = _padded_weights(ctx)
    d2 = (w[:, 2:] - 2 * w[:, 1: ctx.steps + 3] + w[:, : ctx.steps + 2]) / (
        ctx.dt ** 2)
    return alpha * _l2(d2)


@register("bandpass")
def bandpass_cost(ctx, reg_coeffs):
    """Spectral weight outside [band0, band1]
    (regularization_functions.py:47-67)."""
    alpha = reg_coeffs["bandpass"] / float(ctx.steps)
    cdtype = (torch.complex64 if ctx.ops_weight.dtype == torch.float32
              else torch.complex128)
    fft_mag = torch.abs(torch.fft.fft(ctx.ops_weight.to(cdtype), dim=1))
    band = np.asarray(reg_coeffs["band"], dtype=float)
    band_id = (band * float(ctx.total_time)).astype(int)
    half_id = int(ctx.steps / 2)
    lo = torch.sum(fft_mag[:, 0: int(band_id[0])])
    hi = torch.sum(fft_mag[:, int(band_id[1]): half_id])
    return alpha * (lo + hi)


@register("forbidden_coeff_list")
def forbidden_cost(ctx, reg_coeffs):
    """Per-(coeff, level) forbidden-state occupation penalty
    (regularization_functions.py:71-85), in the dressed basis when
    reg_coeffs['forbid_dressed'] and the system is dressed."""
    if ctx.inter_vecs is None:
        raise ValueError(
            "forbidden-state cost requires intermediate states; "
            "set use_inter_vecs=True")
    vecs = ctx.inter_vecs  # [T+1, 2N, V]
    if ctx.v_sorted_iso is not None and reg_coeffs.get("forbid_dressed",
                                                       False):
        vecs = torch.einsum("ji,tjv->tiv", ctx.v_sorted_iso, vecs)
    total = vecs.new_zeros(())
    n = ctx.state_num
    for coeff, state in zip(reg_coeffs["forbidden_coeff_list"],
                            reg_coeffs["states_forbidden_list"]):
        alpha = coeff / float(ctx.steps)
        pop = torch.square(vecs[:, state, :]) + torch.square(
            vecs[:, n + state, :])
        # the reference sums per-vector l2 losses over time
        total = total + alpha * _l2(pop)
    return total


@register("speed_up")
def speed_up_cost(ctx, reg_coeffs):
    """Reward target overlap at every intermediate time
    (regularization_functions.py:88-95)."""
    if ctx.inter_vecs is None:
        raise ValueError("speed_up cost requires intermediate states; "
                         "set use_inter_vecs=True")
    alpha = reg_coeffs["speed_up"] / float(ctx.steps)
    T1 = ctx.inter_vecs.shape[0]  # steps + 1
    target_tiled = ctx.target_vecs[None].expand(
        (T1,) + tuple(ctx.target_vecs.shape))
    ip3 = inner_product_3d(ctx.inter_vecs, target_tiled, ctx.state_num)
    return alpha * 0.5 * torch.square(T1 - ip3)


# keys that are parameters of other costs, not costs themselves
_AUX_KEYS = {"band", "states_forbidden_list", "forbid_dressed"}


def _unknown_key(key, known) -> KeyError:
    close = difflib.get_close_matches(key, sorted(known), n=1)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    return KeyError(f"unknown reg_coeffs key {key!r}{hint} "
                    f"(known: {sorted(known)})")


def validate_reg_coeffs(reg_coeffs: dict | None,
                        state_num: int | None = None) -> None:
    """Early reg_coeffs validation with nearest-key hints: a typo'd key
    raises KeyError; mismatched forbidden lists, an out-of-range level
    (when ``state_num`` is given) and ``bandpass`` without ``band`` raise
    ValueError."""
    if not reg_coeffs:
        return
    valid = set(REGISTRY) | _AUX_KEYS | {"forbidden"}
    for key in reg_coeffs:
        if key not in valid:
            raise _unknown_key(key, valid)
    forb = reg_coeffs.get("forbidden_coeff_list",
                          reg_coeffs.get("forbidden"))
    if forb is not None:
        states = reg_coeffs.get("states_forbidden_list")
        if states is None:
            raise ValueError(
                "'forbidden_coeff_list' requires a matching "
                "'states_forbidden_list' of level indices")
        if len(forb) != len(states):
            raise ValueError(
                f"forbidden_coeff_list has {len(forb)} coefficients for "
                f"{len(states)} states_forbidden_list entries")
        if state_num is not None:
            for i, s in enumerate(states):
                if not 0 <= int(s) < state_num:
                    raise ValueError(
                        f"states_forbidden_list[{i}]={s} is outside the "
                        f"{state_num}-dimensional Hilbert space")
    if "bandpass" in reg_coeffs and "band" not in reg_coeffs:
        raise ValueError(
            "'bandpass' requires 'band' = [f_lo, f_hi] "
            "(regularization_functions.py:47-67)")


def cost_names(reg_coeffs: dict | None) -> list:
    """The selected penalties' names in ``reg_coeffs`` order, with
    ``forbidden_coeff_list`` shown as ``forbidden``."""
    return ["forbidden" if k == "forbidden_coeff_list" else k
            for k in (reg_coeffs or {}) if k not in _AUX_KEYS]


def total_reg_cost(ctx: CostContext, reg_coeffs: dict | None
                   ) -> torch.Tensor:
    """Sum of the penalties selected by ``reg_coeffs``; ``forbidden`` is
    accepted as the README's spelling of ``forbidden_coeff_list``."""
    total = ctx.ops_weight.new_zeros(())
    for key in reg_coeffs or {}:
        if key in _AUX_KEYS:
            continue
        name = "forbidden_coeff_list" if key == "forbidden" else key
        if name not in REGISTRY:
            raise _unknown_key(key, set(REGISTRY) | {"forbidden"})
        cfg = dict(reg_coeffs)
        if key == "forbidden":
            cfg["forbidden_coeff_list"] = reg_coeffs["forbidden"]
        total = total + REGISTRY[name](ctx, cfg)
    return total
