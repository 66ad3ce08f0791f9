"""The comparison that decides ``correct``.

After the window, batches drawn from the run's seed (``check_batches`` of
each client's) are worked out again by the plain reference
(``port_bench/reference``) in complex128 from the circuit's gates, the
initial coefficients and the draws the timed run made, and the timed
path's own outputs are held against it:

- ``rho_max_abs_diff``: the largest entry of |rho_port - rho_reference|
  over the trajectories compared (the readout densities as the port copied
  them to the host);
- ``frame_bits_differing``: the Pauli frame bits that differ, over every
  trajectory;
- ``draw_ks``: whether the port drew its homodyne outcomes from the
  reference's distributions: sqrt(n) times the Kolmogorov-Smirnov distance
  from uniform of the n randomized probability integral transforms of the
  drawn indices of the trajectories compared, pooled over the batches,
  the larger of the two transforms' (``reference.engine.Tape.observe``:
  of the index, and of its probability); under a sound run each follows
  Kolmogorov's distribution whatever n is, so the larger exceeds x with a
  probability under twice Kolmogorov's tail at x.

A trajectory one of whose splits truncates between two singular values
that the reference finds within ``CUT_GAP_MIN`` of each other (relative)
is left out of the density's and the draws' comparison: which direction
of such a pair is kept is fixed by rounding alone, in the port and in the
reference alike (PERF.md gives the readings). The rule reads the
reference's spectrum only, and holds only while it leaves out at most
``MAX_LEFT_OUT`` of the checked trajectories: beyond that every trajectory
is compared.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.engine import Tape, db2eps, replay_batch


CUT_GAP_MIN = 1e-4
MAX_LEFT_OUT = 0.5


def reference_of(batch, config: dict, db: float, device, *, dtype=torch.complex128,
                 tf32: bool = False, rng: np.random.Generator | None = None):
    """(rho, frames, cut gaps, pits (homodynes, B)) of one window batch by
    the reference."""
    indices, sketches = batch.tape.for_reference()
    span = float(config["grid_span"])
    qs = np.linspace(-span, span, int(config["grid_points"]))
    job = batch.job
    tape = Tape(indices, sketches, rng)
    rho, frames, gap = replay_batch(job.gates, job.N, job.coeffs, job.batch, tape, qs=qs,
                                    epsilon=db2eps(db), max_bond_dim=int(config["max_bond_dim"]),
                                    rel_err=float(config["rel_err"]), device=device,
                                    dtype=dtype, tf32=tf32)
    return rho, frames, gap, np.stack(tape.pits) if tape.pits else np.zeros((0, job.batch, 2))


def ks_sqrt_n(u: np.ndarray) -> float:
    """sqrt(n) times the Kolmogorov-Smirnov distance of ``u`` from uniform on [0, 1]."""
    u = np.sort(np.asarray(u, np.float64).ravel())
    n = u.size
    if n == 0:
        return float("nan")
    i = np.arange(1, n + 1)
    return float(np.sqrt(n) * max(np.max(i / n - u), np.max(u - (i - 1) / n)))


def draw_ks(pits: np.ndarray) -> float:
    """The larger of the two transforms' ``ks_sqrt_n`` of (n, 2) transforms."""
    return max(ks_sqrt_n(pits[:, 0]), ks_sqrt_n(pits[:, 1]))


def readings(rho, frames, ref_rho, ref_frames, cut_gap, pits) -> dict:
    """The numbers of one batch (NaN in the port's densities reads as NaN)
    and what :func:`combine` needs: per trajectory, its largest density
    gap, its draws' transforms and whether the cut-gap rule keeps it."""
    diff = np.max(np.abs(np.asarray(rho) - ref_rho), axis=(1, 2))
    keep = np.asarray(cut_gap) >= CUT_GAP_MIN
    return {"rho_max_abs_diff": float(np.max(diff[keep])) if keep.any() else float("nan"),
            "frame_bits_differing": int(np.sum(np.asarray(frames) != ref_frames)),
            "left_out": int(np.sum(~keep)),
            "left_out_diff": float(np.max(diff[~keep])) if (~keep).any() else None,
            "diff": diff, "keep": keep, "pits": np.asarray(pits)}


def combine(per_batch: list[dict]) -> dict:
    """The compared numbers over the checked batches."""
    keep = np.concatenate([r["keep"] for r in per_batch])
    if np.mean(~keep) > MAX_LEFT_OUT:
        keep[:] = True
    diff = np.concatenate([r["diff"] for r in per_batch])[keep]
    pits = np.concatenate([r["pits"].transpose(1, 0, 2) for r in per_batch])[keep]
    return {"rho_max_abs_diff": float(np.max(diff)) if diff.size else float("nan"),
            "frame_bits_differing": int(np.max([r["frame_bits_differing"] for r in per_batch])),
            "draw_ks": draw_ks(pits.reshape(-1, 2)),
            "left_out_share": float(np.mean(~np.concatenate([r["keep"] for r in per_batch])))}


def check(batches, chosen, config: dict, db: float, limits: dict, device, log,
          rng: np.random.Generator | None = None) -> dict:
    """{name: {"value", "limit"}} over the chosen batches (NaN wins); a
    value is None where the reference could not replay a batch."""
    per_batch = []
    for i in chosen:
        b = batches[i]
        try:
            ref_rho, ref_frames, cut_gap, pits = reference_of(b, config, db, device, rng=rng)
        except (NotImplementedError, RuntimeError, StopIteration) as exc:
            log(f"check: the reference could not replay batch {i}: {exc!r}")
            return {name: {"value": None, "limit": limits[name]} for name in limits}
        r = readings(b.out, b.aux, ref_rho, ref_frames, cut_gap, pits)
        log(f"check: batch {i} (client {b.client}, seed {b.job.seed}, {b.job.batch} "
            f"trajectories): " + str({k: r[k] for k in ("rho_max_abs_diff", "frame_bits_differing",
                                                         "left_out", "left_out_diff")})
            + f", draws {r['pits'].size // 2}, draw_ks {draw_ks(r['pits'].reshape(-1, 2)):.4f}")
        per_batch.append(r)
    values = combine(per_batch)
    log(f"check: {values['left_out_share']:.4f} of the checked trajectories left out")
    return {name: {"value": values[name], "limit": limits[name]} for name in limits}

