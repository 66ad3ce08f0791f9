"""Figure-data computation: rate surfaces and regime maps.

Capability parity with reference ``fault-tolerant_.../compute_rate_data.py``
(sequence loading/dedup :13-45, optimal distillation rate per (r, M) :30-66,
transversal / lattice-surgery / distillation surfaces + argmax regime map
:91-149, two-stage physical-distillation composition :152-190), restructured:

- The distillation surface accumulates **per unique sequence**: each sequence
  found at memory point ``M_f`` contributes ``E * min(r, cap(M))`` on the
  sub-grid ``M >= M_f``, applied as one vectorised outer min/max per
  sequence — instead of re-scanning every sequence list per memory column.
- The three gate-rate surfaces share one ``_rate_surface`` helper.
- The physical-distillation composition resolves grid lookups with
  ``np.searchsorted`` index arrays rather than per-cell bisect calls.

All arithmetic on sequence figures of merit stays mpf-exact (object arrays).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .hardware import (
    DepolarisationChannel, find_code_size, lattice_surgery_gate_rate,
    logical_error_rate_bulk_seam, surface_code_size_bulk_seam, transversal_gate_rate,
)
from .physical import PhysicalDistillationRateExtrapolator
from .sequence import LogicalDistillationSequence as DistillationSequence


def load_sequences(path: str) -> dict[int, list[DistillationSequence]]:
    """Deserialise a search-output file, grouped by the memory point at
    which each sequence was found."""
    with open(path) as fh:
        data = json.load(fh)
    by_memory: dict[int, list[DistillationSequence]] = {}
    for entry in data:
        if entry["sequence"] is not None:
            by_memory.setdefault(entry["memory"], []).append(
                DistillationSequence.deserialise(entry["sequence"]))
    return by_memory


def _unique_sequences(by_memory: dict[int, list[DistillationSequence]]):
    """(found_memory, sequence) pairs with serialisation-level duplicates
    dropped, ascending in found_memory."""
    seen: set[str] = set()
    out = []
    for M in sorted(by_memory):
        for seq in by_memory[M]:
            blob = seq.serialise()
            if blob not in seen:
                seen.add(blob)
                out.append((M, seq))
    return out


def compute_distillation_data(path: str, r_rel: np.ndarray, Ms: np.ndarray) -> np.ndarray:
    """Optimal distillation rate per (relative input rate, memory): the max
    over every sequence found at a memory point <= M of
    ``encoding_rate * min(r_rel, input_rate_cap(M))``."""
    by_memory = load_sequences(path)
    if Ms[-1] > max(by_memory) + 1000:
        raise ValueError("Insufficient data. Distillation rates will be suboptimal!")

    r_col = np.asarray(r_rel, dtype=object)[:, None]
    rate = np.zeros((len(r_rel), len(Ms)), dtype=object)
    for M_found, seq in _unique_sequences(by_memory):
        j0 = int(np.searchsorted(np.asarray(Ms), M_found, side="left"))
        if j0 >= len(Ms):
            continue
        caps = np.asarray([seq.input_rate_cap(M) for M in Ms[j0:]], dtype=object)
        surface = seq.encoding_rate * np.minimum(r_col, caps[None, :])
        rate[:, j0:] = np.maximum(rate[:, j0:], surface)
    # NOTE: rates in units of the physical gate rate.
    return rate


@dataclass
class DatasetConfig:
    """Binds the physical parameters to a sequence dataset (reference
    rate_plot.ipynb cell 3)."""

    p_bell: float
    p_target: float
    sequence_file: str
    label: str = ""


@dataclass
class RateArgs:
    r_rel: np.ndarray
    Ms: np.ndarray
    p_target: float
    p_physical: float
    p_bell: float
    p_idle: float
    sequence_file: str


@dataclass
class RateData:
    Z: np.ndarray
    ids: np.ndarray
    rs: list[np.ndarray]
    rate_labels: list[str]
    memory_unit: int
    Ms: np.ndarray
    r_rel: np.ndarray


def _rate_surface(rate_fn: Callable, Ls: list, r_rel: np.ndarray,
                  Ms: np.ndarray) -> np.ndarray:
    """Evaluate a gate-rate model over the (r_rel, Ms) grid; rows whose code
    size search failed (L is None) stay at rate 0."""
    surface = np.full((len(r_rel), len(Ms)), 0.0, dtype=object)
    for i, (r, L) in enumerate(zip(r_rel, Ls)):
        if not L:
            continue
        surface[i, :] = [rate_fn(L, 1, r, M) for M in Ms]
    return surface


def compute_rate_data(args: RateArgs, *, do_LS: bool = True, do_T: bool = True,
                      do_D: bool = True) -> RateData:
    """Rate surfaces for transversal gates, lattice surgery and logical
    distillation + the argmax regime map."""
    r_rel, Ms = args.r_rel, args.Ms
    shape = (len(r_rel), len(Ms))

    idle_channel = DepolarisationChannel(args.p_idle)

    def seam_limited_error(L: int, idle_time: Callable):
        p_seam = idle_channel.apply(args.p_bell, idle_time(L), True)
        return logical_error_rate_bulk_seam(L, args.p_physical, p_seam)

    def code_size_for(idle_time: Callable):
        L, p = find_code_size(seam_limited_error, args.p_target,
                              args=(idle_time,), stepsize=10, always_return=True)
        return L if p <= args.p_target else None

    # Per-method seam idle times: transversal waits L^2 Bell pairs, lattice
    # surgery waits L (reference compute_rate_data.py:109-111).
    zeros = np.full(shape, 0.0, dtype=object)
    rs_T = _rate_surface(
        transversal_gate_rate,
        [code_size_for(lambda L: L ** 2 / r) for r in r_rel],
        r_rel, Ms) if do_T else zeros
    rs_LS = _rate_surface(
        lattice_surgery_gate_rate,
        [code_size_for(lambda L: L / r) for r in r_rel],
        r_rel, Ms) if do_LS else zeros
    rs_D = (compute_distillation_data(args.sequence_file, r_rel, Ms)
            if do_D and args.sequence_file else zeros)

    # Rates in physical-gate-rate units; x5 converts to logical gate rate.
    rs = [rs_T * 5, rs_LS * 5, rs_D * 5]
    Z = np.stack(rs)
    ids = np.argmax(Z, axis=0)
    Z = np.max(Z, axis=0)
    ids[Z == 0] = -1
    L_D = surface_code_size_bulk_seam(args.p_physical, 0, args.p_target)
    return RateData(Z, ids, rs, ["Transversal", "Lattice surgery", "Distillation"],
                    L_D, Ms, r_rel)


def add_physical_distillation(r_rel: np.ndarray, Ms: np.ndarray,
                              second_stage_data: RateData,
                              pd_table_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Compose a physical-distillation first stage with precomputed
    second-stage rate surfaces, optimising the memory split.

    For each total memory ``M_tot`` and raw rate ``r``, every split
    ``M_tot = M_pd + M_star`` maps through the physical-distillation table to
    a second-stage operating point ``(r_star(M_pd), M_star)``; the best split
    wins."""
    Z_2nd, ids_2nd = second_stage_data.Z, second_stage_data.ids
    Ms_2nd, r_rel_2nd = np.asarray(second_stage_data.Ms), second_stage_data.r_rel

    pd_rate = PhysicalDistillationRateExtrapolator(pd_table_path, max_mem=Ms[-1])
    dM = int(np.mean(np.diff(Ms)))
    Ms_ext = np.asarray(list(range(0, Ms[0], dM)) + list(Ms))

    shape = (len(r_rel), len(Ms))
    Z2 = np.zeros(shape, dtype=object)
    ids2 = np.full(shape, -1)
    for i, r in enumerate(r_rel):
        r_stars = [pd_rate.eval(r, M) for M in Ms_ext]
        # second-stage row index per PD memory allocation (-1: off-grid)
        x_idx = np.searchsorted(r_rel_2nd, r_stars, side="right") - 1
        for j, M_tot in enumerate(Ms):
            n_splits = int(np.searchsorted(Ms_ext, M_tot, side="right"))
            y_idx = np.searchsorted(Ms_2nd, M_tot - Ms_ext[:n_splits],
                                    side="right") - 1
            valid = (x_idx[:n_splits] >= 0) & (y_idx >= 0)
            if not valid.any():
                continue
            xs, ys = x_idx[:n_splits][valid], y_idx[valid]
            cell_rates = Z_2nd[xs, ys]
            best = int(np.argmax(cell_rates))
            Z2[i, j] = cell_rates[best]
            ids2[i, j] = ids_2nd[xs[best], ys[best]]
    return Z2, ids2
