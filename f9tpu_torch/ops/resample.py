"""Rational sample-rate conversion by the cycle matrix (port of
`f9tpu/ops/resample.py`): the JAX package's entry names over the plain
layer (`ops/src_plain.py`) and the two kernels, each form running what its
table gives for `src_kernel.src_route`'s answer.  Every form computes each
output from its own window in an order that does not depend on where a
chunk starts, so chunked output equals whole output bit for bit.
"""

from __future__ import annotations

import torch

from ..models.filters import CycleBank, design_cycle_bank
from .cycle_fold import resample_fold_kernel, resample_presliced_fold_kernel
from .src_kernel import resample_auto, resample_kernel, resample_presliced_kernel, src_route
from .src_plain import (  # noqa: F401  (the plain names, read here by the tests)
    _bank_f64, _banded_plan, _cycle_budget, _fold_rows, _gather_core, _h_rev_f32_cached,
    _overlap_rows, _phase_bank_f64, _phase_tables, _plain_presliced, _presliced_fold,
    _unfold_matmul, bank_to_torch, banded_rows_applicable, banded_rows_plan, cycle_matrix_f32,
    resample_gather, rows_marshal_plan, rows_pre_applicable)

__all__ = ["resample", "resample_banded", "resample_gather", "resample_rates",
           "resample_presliced", "cycle_matrix_f32", "bank_to_torch",
           "rows_pre_applicable", "rows_marshal_plan", "banded_rows_applicable",
           "banded_rows_plan"]

#: `resample` of a dense bank by `src_route`'s answer; `_unfold_matmul` for
#: any other answer
_RESAMPLE = {("cycle_fold", True): resample_fold_kernel}
#: `resample_banded` by answer; `resample_gather` for any other
_BANDED = {("cycle_src", True): resample_kernel}
#: `resample_presliced` by answer; `_plain_presliced` for any other
_PRESLICED = {("cycle_src", True): resample_presliced_kernel,
              ("cycle_fold", True): resample_presliced_fold_kernel}


def resample(x: torch.Tensor, bank: CycleBank,
             out_len: int | None = None) -> torch.Tensor:
    """Resample the last axis of float32 ``x (..., T)`` by the bank's ratio:
    ``(..., out_len)`` with ``out_len`` defaulting to ``ceil(T*L/M)``.
    Output sample n estimates the input at position ``n*M/L``.  A varispeed
    bank goes to `resample_banded`; a dense bank runs the `cycle_fold`
    kernel's flat form where `src_route` sends it there, else the float32
    matmul, bit for bit the JAX package's convolution."""
    if bank.G is None:
        return resample_banded(x, bank, out_len=out_len)
    return _RESAMPLE.get(src_route(bank, x.device), _unfold_matmul)(x, bank, out_len)


def resample_banded(x: torch.Tensor, bank: CycleBank,
                    out_len: int | None = None) -> torch.Tensor:
    """The production form for varispeed banks (``bank.G is None``), the
    same design and contract as `resample`: the `cycle_src` kernel's
    launch where `src_route` sends the bank there, else `resample_gather`."""
    return _BANDED.get(src_route(bank, x.device), resample_gather)(x, bank, out_len)


def resample_presliced(xp: torch.Tensor, bank: CycleBank, num_cycles: int) -> torch.Tensor:
    """The cycle conv on an already padded or haloed chunk ``xp (..., T)``,
    ``T >= (num_cycles - 1)*M + W``, with no implicit padding: output cycle
    q reads ``xp[..., q*M : q*M + W]``; returns ``(..., num_cycles * L)``.
    The streaming path's SRC (`f9tpu.ops.resample.resample_presliced`): the
    presliced launch of the kernel `src_route` names, else the fixed-order
    float64 form (`_presliced_fold`, `_gather_core`)."""
    need = (num_cycles - 1) * bank.M + bank.W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    return _PRESLICED.get(src_route(bank, xp.device), _plain_presliced)(xp, bank, num_cycles)


def resample_rates(x: torch.Tensor, rate_in: int, rate_out: int,
                   quality: str = "high", kind: str = "sinc",
                   out_len: int | None = None) -> torch.Tensor:
    """Design (host, cached) + the batch SRC (`src_kernel.resample_auto`) on
    ``x``'s device."""
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    return resample_auto(x, bank, out_len=out_len)
