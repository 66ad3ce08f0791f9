"""Distillation stages and sequence recurrences.

Parity with reference ``fault-tolerant_.../sequence_class.py``: Stage registry
+ JSON (de)serialisation with mpf round-trip (:19-64), [[n,k,d]] quantum EC
with a binomial failure model (:67-81), [n,1,n] classical repetition stages
(:84-101), init/injection/grow stages (:104-169) and the incremental
``LogicalDistillationSequence`` recurrences for memory floor, encoding rate,
space-time volume and multiplicity (:172-278).

Precision: the reference sets ``mp.dps = 24`` at ``sequence_class.py:5`` but
then imports ``ConstantRateDistillation/Distillation_functions.py`` whose
line 5 sets ``mp.dps = 80`` — mpmath precision is a process-global, so the
reference pipeline *effectively* runs at 80 digits. We pin 80 explicitly.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod

import mpmath
from mpmath import binomial, inf, mpf

from .hardware import balanced_depolarisation_noise, surface_code_error, surface_code_qubits
from .repetition import ED_n_1_n

mpmath.mp.dps = 80


def scalar_error(p):
    """Collapse a Pauli probability vector to a scalar error (X+Z+Y)."""
    if isinstance(p, mpf):
        return p
    if isinstance(p, list) and len(p) >= 4:
        return mpf(p[1] + p[2] + p[3])
    raise ValueError(
        "Invalid input. Expected an mpf number or a list with at least four elements."
    )


class Stage(ABC):
    _subclass_registry: dict[str, type] = {}

    def __init__(self, code, L, p_L, p_local):
        self.n, self.k, self.d = code
        self.L: int = L
        self.p_L = p_L
        self.p_local = p_local
        self.qubit_size: int = surface_code_qubits(L)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        Stage._subclass_registry[cls.__name__] = cls

    # -- serialisation ------------------------------------------------------
    def _serialisable_args(self) -> list:
        return [repr(arg) if isinstance(arg, mpf) else arg for arg in self.args()]

    @staticmethod
    def _from_serialised_args(args: list) -> list:
        return [
            mpf(arg[5:-2]) if isinstance(arg, str) and arg[:3] == "mpf" else arg
            for arg in args
        ]

    def serialise(self) -> str:
        return json.dumps({"type": self.__class__.__name__, "args": self._serialisable_args()})

    @classmethod
    def from_serialised(cls, json_str: str) -> "Stage":
        data = json.loads(json_str)
        stage_cls = cls._subclass_registry.get(data["type"])
        if stage_cls is None:
            raise ValueError(f"Unknown stage type: {data['type']}")
        return stage_cls(*cls._from_serialised_args(data["args"]))

    # -- abstract interface -------------------------------------------------
    @abstractmethod
    def __str__(self) -> str: ...

    @abstractmethod
    def args(self) -> list: ...

    @abstractmethod
    def get_logical_depth(self) -> int: ...

    @abstractmethod
    def get_physical_depth(self) -> int: ...

    @abstractmethod
    def compute_error_metrics(self, in_error):
        """(output error, failure probability) given the input error."""


class QuantumStage(Stage):
    """[[n,k,d]] quantum error-detection stage with binomial failure model."""

    def __str__(self):
        return f"[{[self.n, self.k, self.d]}]"

    def args(self):
        return [(self.n, self.k, self.d), self.L, self.p_L, self.p_local]

    def get_logical_depth(self):
        return 3 * self.n - 2 - self.k

    def get_physical_depth(self):
        return self.get_logical_depth() * 5

    def compute_error_metrics(self, in_error):
        in_error = scalar_error(in_error)
        q = (1 - in_error) * ((1 - self.p_L) ** self.get_logical_depth())
        bin_sum = sum(binomial(self.n, i) * (1 - q) ** i * q ** (self.n - i) for i in range(self.d))
        qn = q**self.n
        return (1 - bin_sum) / qn, 1 - qn


class ClassicalStage(Stage):
    """[n,1,n] classical repetition stage in basis X/Y/Z."""

    def __init__(self, code, basis, L, p_L, p_local):
        self.basis = basis
        super().__init__(code, L, p_L, p_local)
        if self.n != self.d:
            raise NotImplementedError("Only [n, 1, n] classical codes are implemented.")

    def __str__(self):
        return f"{[self.n, self.k, self.d]}_{self.basis}"

    def args(self):
        return [(self.n, self.k, self.d), self.basis, self.L, self.p_L, self.p_local]

    def get_logical_depth(self):
        return 3 * self.n - 2 - self.k

    def get_physical_depth(self):
        return self.get_logical_depth() * 5

    def compute_error_metrics(self, in_error):
        rate, out_error, _ = ED_n_1_n(self.n, in_error=in_error, basis=self.basis)
        p_fail = 1 - self.n * rate
        out_error = balanced_depolarisation_noise(out_error, self.p_L, self.get_logical_depth())
        return out_error, p_fail


class InitStage(Stage):
    """Source stage: raw Bell pairs at a given error in distance-L patches."""

    def __init__(self, error, L, p_local, p_L=None):
        p_L = surface_code_error(L, p_local) if p_L is None else p_L
        super().__init__((1, 1, 0), L, p_L, p_local)
        self.error = error

    def __str__(self):
        return "Initialisation"

    def args(self):
        return [self.error, self.L, self.p_local]

    def get_logical_depth(self):
        return 0

    def get_physical_depth(self):
        return 0

    def compute_error_metrics(self, _in_error):
        return self.error, 0.0


class InjectionStage(Stage):
    """Magic-state injection into an L=3 patch (lookup table; reference
    values only exist for p_local = 0.1% and 1% / 5% input errors)."""

    def __init__(self, L, p_local):
        if L != 3:
            raise NotImplementedError(f"Injection into code size {L} not implemented.")
        if str(p_local) != "0.001":
            raise NotImplementedError("Injection only implemented for p_local = 0.1%")
        p_L = surface_code_error(L, p_local)
        super().__init__((1, 1, 0), L, p_L, p_local)
        self.p_fail = 1 - (1 - mpf("8e-2")) ** 2

    def __str__(self):
        return "Injection"

    def args(self):
        return [self.L, self.p_local]

    def get_logical_depth(self):
        return 0

    def get_physical_depth(self):
        return 2 * 5  # two rounds of syndrome extraction

    def compute_error_metrics(self, in_error):
        table = {"0.01": mpf("1.25e-2"), "0.05": mpf("5.2e-2")}
        key = str(in_error)
        if key not in table:
            raise NotImplementedError("Injection only implemented for 1% and 5% input errors")
        return table[key], self.p_fail


class GrowStage(Stage):
    """Surface-code patch growth L_in -> L_out."""

    def __init__(self, L_out, L_in, p_L_in, p_local):
        self.L_in = L_in
        self.p_L_in = p_L_in
        super().__init__((1, 1, 0), L_out, surface_code_error(L_out, p_local), p_local)

    def __str__(self):
        return "Growing"

    def args(self):
        return [self.L, self.L_in, self.p_L_in, self.p_local]

    def get_logical_depth(self):
        return 2

    def get_physical_depth(self):
        return self.get_logical_depth() * self.L_in * 4

    def compute_error_metrics(self, in_error):
        depth = self.get_logical_depth()
        p_L = self.p_L_in
        if isinstance(in_error, list):
            p_out = balanced_depolarisation_noise(in_error, p_L, depth)
        else:
            p_out = 1 - (1 - in_error) * ((1 - p_L) ** depth)
        return p_out, 0.0


class LogicalDistillationSequence:
    """A sequence of stages with incrementally maintained figures of merit:

    min_memory_req — memory floor to run the pipeline at all;
    encoding_rate  — surviving logical qubits per input qubit;
    M / M_idle     — space-time volume of processing / idle buffering;
    K              — output multiplicity (product of stage k's).
    Recurrences mirror reference ``add_stage`` (sequence_class.py:221-241).
    """

    def __init__(self, init_stage: InitStage):
        self.stages: list[Stage] = [init_stage]
        self.stage_p_fail = [mpf(0.0)]
        self.stage_p_out = [init_stage.error]
        self.min_memory_req: int = 0
        self.encoding_rate = 1
        self.M = 0
        self.M_idle = 0
        self.K: int = 1

    def __str__(self):
        lines = ["Distillation stages:"]
        for stage, p_out in zip(self.stages, self.stage_p_out):
            lines.append(
                f"{str(stage):<15}: L={stage.L}, p_L={float(stage.p_L):.3e}, "
                f"p_out={float(scalar_error(p_out)):.3e}"
            )
        lines.append(
            f"Summary: logical error rate={float(self.p_out):.3e}, "
            f"memory requirement={self.min_memory_req}, "
            f"encoding rate={float(self.encoding_rate):.3e}"
        )
        return "\n".join(lines)

    # -- serialisation ------------------------------------------------------
    def serialise(self) -> str:
        return json.dumps([stage.serialise() for stage in self.stages])

    @staticmethod
    def deserialise(data_str: str) -> "LogicalDistillationSequence":
        strs = iter(json.loads(data_str))
        seq = LogicalDistillationSequence(Stage.from_serialised(next(strs)))
        for s in strs:
            seq.add_stage(Stage.from_serialised(s))
        return seq

    # -- recurrences --------------------------------------------------------
    def add_stage(self, stage: Stage):
        n, k = stage.n, stage.k
        p_out, p_fail = stage.compute_error_metrics(self.stage_p_out[-1])

        T = stage.get_physical_depth()
        K = self.K
        E = self.encoding_rate
        size = stage.qubit_size
        min_mem = self.min_memory_req
        dM = (size - self.qubit_size) * n * K

        self.stages.append(stage)
        self.stage_p_fail.append(p_fail)
        self.stage_p_out.append(p_out)
        self.min_memory_req = max(n * K * size, (n - 1) * K * size + min_mem + dM)
        self.encoding_rate *= (1 - p_fail) * k / n
        self.M += T * E * K * size
        self.M_idle += size * K * (n - 1) / 2
        self.K *= k

    def shallow_copy(self) -> "LogicalDistillationSequence":
        copy = LogicalDistillationSequence.__new__(LogicalDistillationSequence)
        copy.stages = self.stages.copy()
        copy.stage_p_fail = self.stage_p_fail.copy()
        copy.stage_p_out = self.stage_p_out.copy()
        copy.min_memory_req = self.min_memory_req
        copy.encoding_rate = self.encoding_rate
        copy.M = self.M
        copy.M_idle = self.M_idle
        copy.K = self.K
        return copy

    # -- derived quantities -------------------------------------------------
    @property
    def p_out(self):
        return scalar_error(self.stage_p_out[-1])

    @property
    def p_L(self):
        return self.stages[-1].p_L

    @property
    def L(self):
        return self.stages[-1].L

    @property
    def qubit_size(self):
        return self.stages[-1].qubit_size

    def input_rate_cap(self, allocated_memory: int, local_gate_rate: float = 1.0):
        if self.M == 0:
            # No processing space-time volume (bare init / zero-depth stages):
            # memory never throttles the input rate. The reference divides by
            # zero here (sequence_class.py:268-270) — latent crash its target
            # settings never reached.
            return inf
        cap = local_gate_rate * (allocated_memory - self.M_idle) / self.M
        return max(0.0, cap)

    def distillation_rate(self, allocated_memory: int, max_input_rate=inf,
                          local_gate_rate: float = 1.0):
        if allocated_memory < self.min_memory_req:
            return 0.0
        if max_input_rate == 0.0:
            return self.encoding_rate
        input_rate = self.input_rate_cap(allocated_memory, local_gate_rate)
        return min(max_input_rate, input_rate) * self.encoding_rate
