"""Small fixed CV gate-list circuits of the GKP error-correction
experiments (counterpart of
``quantum_computations_tpu/pipelines/cv_circuits.py``).

Textbook constructions against the port's CV gate classes: the
two-ancilla qunaught (tesseract) EC gadget, single-quadrature and
Steane-style EC, and the two GKP Bell-pair preparations. The gate
sequences are the physics content and equal the JAX package's, gate by
gate and parameter by parameter.
"""

from __future__ import annotations

from ..cv.gates import BS, CZ, F, Insert, Mp, Mq
from ..cv.states import State
from ..gkp.gates import MBCZ


def qunaught_error_correction(eps: float):
    """Two qunaught ancillae + two beamsplitters, then a q and a p readout
    on the first ancilla; the displacement correction implied by the two
    homodyne outcomes is applied virtually by whoever runs the circuit."""
    return [
        Insert(1, State.QUNAUGHT, gkp_epsilon=eps),
        Insert(2, State.QUNAUGHT, gkp_epsilon=eps),
        BS(2, 1),
        BS(1, 0),
        Mq(0),
        Mp(0),
    ]


def quadrature_correction(eps: float):
    return [
        Insert(1, State.GKP_ZERO, gkp_epsilon=eps),
        CZ(0, 1),
        Mp(1),
    ]


def steane_error_correction(eps: float):
    return [
        *quadrature_correction(eps),
        F(0, dagger=True),
        *quadrature_correction(eps),
        F(0),
    ]


def bell_standard(eps: float):
    return [
        Insert(0, State.GKP_T, gkp_epsilon=eps),
        Insert(1, State.GKP_PLUS, gkp_epsilon=eps),
        *MBCZ(0, 1, epsilon=eps).compile(),
        F(1),
    ]


def bell_qunaught(eps: float):
    return [
        Insert(0, State.QUNAUGHT, gkp_epsilon=eps),
        Insert(1, State.QUNAUGHT, gkp_epsilon=eps),
        BS(0, 1),
    ]
