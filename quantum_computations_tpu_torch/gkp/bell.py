"""GKP Bell states inserted as bond-2 MPS segments (counterpart of
``quantum_computations_tpu/gkp/bell.py``).

The qunaught Bell state is prepared analytically as a two-tensor MPS with
internal bond 2 (c0 |0>|0> + c1 |1>|1>); ``InsertBell`` splices it into
the chain exactly and without an SVD (:func:`splice_product_segment`).
"""

from __future__ import annotations

import logging
from enum import Enum

import numpy as np
import torch

from ..config import complex_dtype
from ..cv.gates import Insert
from ..cv.mps import MPS
from ..cv.states import State, _eval_grid

logger = logging.getLogger(__name__)

PI = np.pi


class GKPBellState(Enum):
    PLUS = 1
    T = 2
    Tdg = 3

    def __repr__(self):
        return "GKP_BELL_" + self.name

    def __str__(self):
        return self.__repr__()

    def coefficients(self):
        match self:
            case GKPBellState.PLUS:
                return (1.0, 1.0)
            case GKPBellState.T:
                return (1.0, np.exp(1j * PI / 8))
            case GKPBellState.Tdg:
                return (1.0, np.exp(-1j * PI / 8))

    def eval(self, qs, gkp_epsilon=None, *, device=None, dtype=None) -> MPS:
        """The Bell pair as a two-mode MPS with bond 2 on the numpy grid
        ``qs`` (validated), on ``device`` (default ``cuda``) in ``dtype``
        (default :func:`..config.complex_dtype` of it). The wavefunctions
        are formed in complex128 and cast last."""
        if gkp_epsilon is not None and gkp_epsilon <= 0:
            raise ValueError("epsilon must be a positive real number")
        qs = np.asarray(qs)
        q = _eval_grid(qs, device)
        c0, c1 = self.coefficients()
        zero = State.GKP_ZERO.eval(q, gkp_epsilon, dtype=torch.complex128)
        one = State.GKP_ONE.eval(q, gkp_epsilon, dtype=torch.complex128)
        bell = torch.stack([2 ** (-1 / 4) * c0 * zero, 2 ** (-1 / 4) * c1 * one],
                           dim=-1)  # (d, 2)
        bell = bell[None, :, :]  # (1, d, 2)
        return MPS(qs, [bell, bell.permute(2, 1, 0)], device=q.device,
                   dtype=dtype or complex_dtype(q.device))


def splice_product_segment(t1, b1, b2):
    """Exact SVD-free insertion tensors for a product two-tensor segment.

    A Bell pair is a product state with respect to the rest of the chain,
    so the chain bond r passes through the new tensors on an identity and
    the pair's internal bond 2 rides alongside, giving bonds r | 2r | r:

        b1'[beta, x, (beta', c)] = delta(beta, beta') b1[x, c]
        b2'[(beta, c), y, beta'] = delta(beta, beta') b2[c, y]

    Broadcast products with the identity: every entry is an exact copy or
    an exact zero. b1 (..., d, 2) and b2 (..., 2, d) may carry leading
    batch axes (one pair per trajectory). The next two-mode gate's split
    truncates the 2r bond.
    """
    r = t1.shape[-1]
    d = b1.shape[-2]
    batch = b1.shape[:-2]
    eye = torch.eye(r, dtype=t1.dtype, device=t1.device)
    b1_t = (eye[:, None, :, None] * b1[..., None, :, None, :]).reshape(*batch, r, d, 2 * r)
    b2_t = (eye[:, None, None, :] * b2[..., None, :, :, None]).reshape(*batch, 2 * r, d, r)
    return b1_t, b2_t


class InsertBell(Insert):
    """Insert a two-mode GKP Bell state at `index`."""

    def __init__(self, index, state: GKPBellState = GKPBellState.PLUS, *, gkp_epsilon=None, **kwargs):
        if not isinstance(state, GKPBellState):
            raise TypeError(f"Expected GKPBellState obj but found {type(state)}")
        super().__init__(index, state, gkp_epsilon=gkp_epsilon, **kwargs)

    def apply(self, mps: MPS, **_):
        idx = self.index
        if idx < 0 or idx > len(mps):
            raise IndexError(f"Cannot insert mode at index {idx} for MPS of length {len(mps)}")
        bell = self.arg.eval(mps.domain, self.gkp_epsilon, device=mps.device,
                             dtype=mps.dtype)
        if idx == 0:
            mps.tensors = bell.tensors + mps.tensors
            return
        if idx == len(mps):
            mps.tensors = mps.tensors + bell.tensors
            return
        # ... t1 | (b1 - b2) | t2 ...: the pair is a product segment, so
        # the splice is exact and SVD-free
        b1, b2 = bell[0][0, :, :], bell[1][:, :, 0]  # (d, 2), (2, d)
        b1_t, b2_t = splice_product_segment(mps[idx - 1], b1, b2)
        mps.tensors.insert(idx, b1_t)
        mps.tensors.insert(idx + 1, b2_t)
