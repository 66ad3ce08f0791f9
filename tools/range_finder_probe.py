"""Probe of the complex64 randomized range finder in the eager GKP engine.

    python3 tools/range_finder_probe.py [--device cpu]

Runs G1 = [H(0), CZ(0, 1), H(1)] (seed 5, d = 1000 on [-20, 20], 10 dB
ancillas, bond cap 100, rel_err 1e-2, the stream threshold at 4 d^2, the
BS split by three CZ splits) as ``chip_smoke.py`` phase 8 does: complex128
seeded, then complex64 with its outcomes and sketches replayed, once with
the port's ``orthonormalize`` and once with a control that forms the range
finder's Gram in complex64 (the port's form before the fix). It prints:

- 1 - fidelity of the whole MPS against complex128 after every two-mode
  split, for both versions;
- for every randomized split of the complex64 run, the error of the
  truncated split against the best error at its rank (float64 SVD), and
  the largest eigenvalue of Q^H Q of its range finder, for both versions;
- the time of ``orthonormalize`` on (2000, 110) and (1e5, 110) complex64
  matrices and of G1 and G2 per circuit (complex64, default threshold),
  both versions alternating (new, old, old, new).

Ends with one JSON line of these numbers. Needs a CUDA device unless
``--device cpu`` is given (then no times are taken).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from quantum_computations_tpu_torch import gkp  # noqa: E402
from quantum_computations_tpu_torch.config import full_fp32_matmul  # noqa: E402
from quantum_computations_tpu_torch.cv import MPS, gates as cg  # noqa: E402
from quantum_computations_tpu_torch.dv import State, gates as dvg  # noqa: E402
from quantum_computations_tpu_torch.ops import linalg  # noqa: E402

C128 = torch.complex128


@full_fp32_matmul()
def gram_c64_orthonormalize(Y, *, method="eigh"):
    """Control: ``orthonormalize`` with the range finder's Gram and Q0 in
    Y's dtype."""
    if method != "eigh":
        return linalg.orthonormalize(Y, method=method)
    Q = Y @ linalg._hermitian_inv_sqrt(Y.mH @ Y)
    eye = torch.eye(Q.shape[1], dtype=Q.dtype, device=Q.device)
    return Q @ (1.5 * eye - 0.5 * (Q.mH @ Q))


def version(name):
    if name == "port":
        return contextlib.nullcontext()
    return cs.patched(linalg, "orthonormalize", gram_c64_orthonormalize)


def run(name, device, dtype=torch.complex64, seed=cs.GKP_SEED):
    circ = gkp.MBGKPCircuit.transpile(cs.gkp_circuit(name, dvg))
    circ.fill()
    sim = gkp.Simulator(circ, ancilla_epsilon=cs.CV_EPS, rng_seed=seed,
                        svd_options={"max_bond_dim": 100, "rel_err": 1e-2})
    return sim.run(gkp.parse_to_mps([State.ZERO] * 2, cs.CV_EPS, cs.CV_QS,
                                    device=device, dtype=dtype))


@contextlib.contextmanager
def recording(snapshots, splits):
    """Keep the MPS after every two-mode split (in complex128) and each
    randomized range finder's (A, sketch, l, q)."""
    real_pts, real_rf = cg._pair_transform_split, linalg.randomized_range_finder

    def pts(mps, *args):
        real_pts(mps, *args)
        snapshots.append(MPS(mps.domain, [t.clone() for t in mps.tensors],
                             device=mps.device, dtype=C128))

    def rf(A, l, q, generator=None, *, sketch=None):
        O = linalg._gaussian_sketch(A.shape[1], l, generator, A)
        splits.append((A.clone(), O.clone(), l, q))
        return real_rf(A, l, q, generator, sketch=O)

    with cs.patched(cg, "_pair_transform_split", pts), \
            cs.patched(linalg, "randomized_range_finder", rf):
        yield


def split_errors(A, O, l, q):
    """The truncated split's error against the best at its rank, and the
    largest eigenvalue of Q^H Q, for each version."""
    s = torch.linalg.svdvals(A.to(C128))
    out = {}
    for name in ("port", "gram_c64"):
        with version(name):
            U, sv, Vh = linalg.randomized_truncated_svd(A, 100, sketch=O)
            Q = linalg.randomized_range_finder(A.T if A.shape[0] < A.shape[1] else A,
                                               l, q, sketch=O)
        r = int(linalg.truncation_rank_mask(sv, 100, 0.0, 1e-2)[0])
        approx = (U[:, :r].to(C128) * sv[:r].double()) @ Vh[:r].to(C128)
        out[name] = {"rank": r,
                     "error": float(torch.linalg.matrix_norm(A.to(C128) - approx)),
                     "best_error": float(torch.sqrt((s[r:] ** 2).sum())),
                     "max_eig_QhQ": float(torch.linalg.eigvalsh((Q.mH @ Q).to(C128)).max())}
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args().device
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"per_split_infidelity": {}, "randomized_splits": {}}
    with cs.stream_threshold(cs.GKP_STREAM_THRESHOLD), cs.bs_decomp("cz"):
        ref_snaps, ref_splits = [], []
        with cs.x64_dtype(), cs.gkp_tape() as ref_tape, recording(ref_snaps, ref_splits):
            ref, _ = run("G1", device, dtype=C128)
        for name in ("port", "gram_c64"):
            snaps, splits = [], []
            with cs.gkp_tape(ref_tape), recording(snaps, splits), version(name):
                got, _ = run("G1", device)
            result["per_split_infidelity"][name] = [
                1 - cs.cv_fidelity(a, b) for a, b in zip(ref_snaps, snaps, strict=True)]
            result[f"infidelity_{name}"] = 1 - cs.cv_fidelity(ref, got)
            if name == "port":
                result["randomized_splits"] = [split_errors(*x) for x in splits]
    if device == "cuda":
        times = []
        for name in ("port", "gram_c64", "gram_c64", "port"):
            with version(name):
                row = {"version": name}
                for n in (2000, 100000):
                    Y = torch.randn(n, 110, dtype=torch.complex64, device="cuda")
                    row[f"orthonormalize_ms_{n}"] = cs.cuda_ms(
                        lambda: linalg.orthonormalize(Y), 20)  # noqa: B023
                for name_ in ("G1", "G2"):
                    row[f"{name_}_ms"] = cs.gkp_timing(name_)["ms_per_circuit"]
                times.append(row)
        result["times"] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
