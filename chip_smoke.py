"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, checks the state-vector
engine in slab and in chain mode against a dense numpy reference, then
drives both of its paths at full width, N = 30 (two float32 planes of
4 GiB each, updated in place): ``FastStatevector(30, device="cuda")`` in
slab mode through ``run_compiled``, and in chain mode through ``run``.
Then it times each kernel at the shape its path gives it, beside its bound,
its plain version and one library call.

Then the CV grid-MPS engine, ``cv.Simulator(gates).run(mps)``, at the
production grid (d = 1000 on [-20, 20], 10 dB GKP states, bond cap 100,
rel_err 1e-2): Steane EC (S), qunaught EC (Q), a three-mode tour of every
gate class (T), and Q at bond cap 40 on the randomized SVD (Q40). Each runs
in complex128 with seeded outcomes and in complex64 with those outcomes
forced; the states, the outcomes' probabilities and the norms are held
against each other, and S once more against a complex128 run on the CPU.
Two controls rerun each circuit in complex64 in a precision the port must
not fall back to (the SVD's Gram in complex64; grid tables from a float32
grid), and the complex64 limits must catch each of them.

Then the eager measurement-based GKP engine, ``gkp.Simulator(circuit,
ancilla_epsilon).run(parse_to_mps(...))``, at the same grid and bond cap on
two 2-qubit circuits (G1 = [H(0), CZ(0, 1), H(1)]; G2 runs every gadget
class), with the stream threshold lowered so the interior split of each
two-qubit gadget streams, by the direct route (the default) and the
three-CZ route: complex128 with a seed, complex64 and two controls with its
outcomes and sketches replayed, each held against complex128 and the DV
engine's state; G1 over eight seeds by both routes; then times at the
lowered and the default threshold, one streamed split just under the
default threshold against the materialised split (the JAX test's
criteria), and one of 10^10 elements, the size the streamed path is for
(its time, peak memory and error).

Then the production GKP trajectory engine, ``BatchedGKP(qs, epsilon,
svd_options, adaptive=True, granularity="op").run_circuit(...)`` and its
``readout``, on bench.py's workload: the depth-8 two-qubit RB circuit
``random_circ(2, 8, default_rng(123))``, d = 1000, 10 dB, bond cap 100,
rel_err 1e-2, 16 trajectories (phase 9): 9a the largest fused single
gadget and pair measure of the run (the pair by each of its four paths)
in complex64 against complex128, their times and peak memory; 9b the
batch's time, host syncs, peak memory, device-busy share and per-op
times from a trace, its op counts and largest bond pairs, and each
trajectory's fidelity to the DV state; 9c one trajectory in complex64
and two controls against complex128 with the draws replayed; 9d, when a
split streams, the largest streamed split by both BS routes.

Then the first paper's Grover path and the other pipelines (phase 10):
10a Grover [0, 4] at 12.5 dB through ``pipelines/grover_batched.main``
at its production settings (d = 1000, chi = 100), one batch of two
trajectories: time, host syncs, peak memory, a trace's busy share and
per-op times, op counts, largest bonds, each trajectory's success and raw
trace; 10b, when a split streams, its largest streamed split by both BS
routes against the materialised split; 10c one Grover trajectory at d =
300, chi = 25, complex64 and two controls against complex128, replayed;
10d ``gkp/compiled.CompiledGKP`` through ``rb_compiled`` and
``grover_compiled`` at their own sizes: time, peak, host syncs by source
(cuSOLVER's alone) and complex64 against complex128; 10e ``grover.main``
on its test circuit, ``rb.sample_depth``, ``clifford_fidelity.job``
against the JAX pipeline's stored rows, and process tomography on the
card.

Then engine threads and the second paper (phase 11): 11a 10a's Grover
cell through ``grover_batched.main`` and bench.py's RB settings through
``rb_batched.sample_depth_batched(runners=...)``, each with 1, 2 and 4
engines (one Python thread and one CUDA stream per engine): s per
trajectory, host syncs, peak memory and, at one engine, the busy share
over all streams, and every threaded row against the serial row of the same seed; 11b the
``gkp_ec_validation`` experiments at their default grids in complex64 and
complex128 (complex64 within ``EC_C64_LIMITS`` of complex128, complex128
held to the JAX tests' thresholds) and the five ``cv_circuits`` lists
through ``cv.Simulator`` at d = 1000, cap 100, with their times.

Then the sharded engines on ``torch.distributed`` (phase 12), each world
started by ``parallel.launch`` (spawned ranks, a ``FileStore``): 12b a
world of 4 ranks on the one card over gloo runs ``ShardMapStateVector(28)``
(a mixed circuit with gates on rank-bit qubits, ``run_fused_slab`` with its
planner, a measurement of a rank-bit qubit, samples) and
``ShardedStateVector(28)``; 12a a world of one under NCCL runs
``ShardMapStateVector(30)`` through ``run_fused_slab``, ``measure`` and
``sample``, every marginal and 64 amplitudes held against
``FastStatevector(30)`` within limits read at N = 26 against complex128,
then 12b's steps as the reference of the world of 4; 12c
``BatchedGKP.run_circuit(data_sharding=data_mesh())`` on bench.py's
workload at 1, 2 and 4 ranks and 10a's Grover cell at 1 and 4, every row
against the serial rows of the same seed. Each world's time, peak memory
per rank, host syncs and exchange times are printed.

Then the Hermitian eigensolver of the randomized split's Gram matrices
(phase 13), ``ops.herm_eigh_small``: built, held against its plain version
and ``torch.linalg.eigh`` on random Hermitian and rank-deficient graded PSD
batches of sides 1 to 128, then timed at the split's shapes (B, 110), B =
16, 10, 8 and 1, beside its bound, the plain version and the library call,
then against the library per call at B = 1 to 8 and sides 26 to 128 (the
crossover below which ``ops/linalg.py`` keeps cuSOLVER) and in RB batches
of 1 to 4 trajectories with either route forced (phase 9b checks its
launches: 16 per randomized split pass the kernel takes);
``python -c 'import chip_smoke as c; c.eigh_small_main()'`` runs it alone.

Prints one line per phase with its wall time, JSON lines of the paths'
numbers, then the card's name and power limit, a JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Any
failure exits non-zero and prints no result; so does a machine without a
CUDA device.

Imports nothing of JAX: the references are the port's plain versions,
numpy, and the port's own CPU path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# H100 SXM data-sheet peaks (FP32 outside the tensor cores, dense TF32 on
# them; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 67e12  # FP64 on the tensor cores (data sheet)
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

N_FULL = 30          # full width: 2 x 4 GiB float32 planes
N_CHECK = 14         # engine vs dense complex128 reference
REPS = 5             # timed chains (slab) or circuits (chain) per main path
WARMUP = 3           # untimed runs before them
KERNEL_RTOL = 1e-5   # max|kernel - plain| <= KERNEL_RTOL * max|plain|
_T0 = time.perf_counter()


def log(msg: str):
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name} ...")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name} ok in {time.perf_counter() - self.t:.2f}s")
        return False


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def random_window(d: int, seed: int):
    """A random unitary window, TRANSPOSED, as float32 (wt_re, wt_im)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    wt = q.T
    return (torch.from_numpy(np.ascontiguousarray(wt.real, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(wt.imag, np.float32)).cuda())


def random_planes(n: int, seed: int):
    """Unit-norm random planes made on the card (2^N values each)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = (2.0 * n) ** -0.5
    re = torch.randn(n, device="cuda", generator=g).mul_(scale)
    im = torch.randn(n, device="cuda", generator=g).mul_(scale)
    return re, im


def kernel_vs_plain(kernel, plain, re, im, *args) -> tuple[float, float]:
    """(max abs error, relative error) of the in-place ``kernel`` against
    its ``plain`` version on the same inputs; raises on disagreement."""
    name = kernel.__name__
    want_r, want_i = plain(re, im, *args)
    got_r, got_i = re.clone(), im.clone()
    ptrs = (got_r.data_ptr(), got_i.data_ptr())
    out = kernel(got_r, got_i, *args)
    torch.cuda.synchronize()
    if (out[0].data_ptr(), out[1].data_ptr()) != ptrs:
        raise AssertionError(f"{name} did not update the planes in place")
    err = max((got_r - want_r).abs().max().item(),
              (got_i - want_i).abs().max().item())
    scale = max(want_r.abs().max().item(), want_i.abs().max().item())
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs err {err:.3e} > {KERNEL_RTOL} x {scale:.3e}")
    return err, err / scale


def random_unitary(d: int, rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q.astype(np.complex64)


def chain_operator(us, bits) -> tuple[np.ndarray, int, int]:
    """A chain on contiguous amplitude bits lo..hi composed on the host into
    one (2^w, 2^w) complex64 operator, w = hi - lo + 1: gates on different
    bits commute, gates on one bit compose in chain order. Returns
    ``(operator, lo, w)``."""
    lo, hi = min(bits), max(bits)
    if set(bits) != set(range(lo, hi + 1)):
        raise ValueError(f"chain bits {sorted(set(bits))} are not contiguous")
    per_bit = {b: np.eye(2, dtype=np.complex128) for b in range(lo, hi + 1)}
    for u, b in zip(us, bits):
        per_bit[b] = np.asarray(u, np.complex128) @ per_bit[b]
    op = np.ones((1, 1), np.complex128)
    for b in range(hi, lo - 1, -1):  # bit hi is the most significant
        op = np.kron(op, per_bit[b])
    return op.astype(np.complex64), lo, hi - lo + 1


def library_call(mat, lo: int, w: int, n_qubits: int, device="cuda"):
    """One complex64 ``torch.matmul`` applying the (2^w, 2^w) operator
    ``mat`` to amplitude bits lo..lo+w-1 of a flat complex state: on the
    (2^(N-lo-w), 2^w, 2^lo) view, or as ``x.view(-1, 2^w) @ mat^T`` when
    lo = 0. The operator is built here, outside any timed region."""
    m = torch.from_numpy(np.ascontiguousarray(mat, np.complex64)).to(device)
    if lo == 0:
        mt = m.T.contiguous()
        return lambda x: torch.matmul(x.view(-1, 1 << w), mt)
    shape = (1 << (n_qubits - lo - w), 1 << w, 1 << lo)
    return lambda x: torch.matmul(m, x.view(shape))


def cx_expected_diff(re, im, snap_re, snap_im, control: int, target: int,
                     n_qubits: int) -> float:
    """max |state - CX(control, target) snapshot| for big-endian
    control > target, without building the expected planes."""
    shape = (1 << target, 2, 1 << (control - target - 1), 2,
             1 << (n_qubits - control - 1))
    err = 0.0
    for x, s in ((re, snap_re), (im, snap_im)):
        x, s = x.view(shape), s.view(shape)
        err = max(err, (x[:, :, :, 0] - s[:, :, :, 0]).abs().max().item(),
                  (x[:, :, :, 1] - s[:, :, :, 1].flip(1)).abs().max().item())
    return err


def bound(n_bytes: float, fp32_ops: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) from data-sheet peaks."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = fp32_ops / PEAK_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def dense_reference(gates, n: int) -> np.ndarray:
    """complex128 state vector of ``gates`` from |0...0>, big-endian."""
    psi = np.zeros((2,) * n, np.complex128)
    psi[(0,) * n] = 1.0
    for g in gates:
        mat, tgts = (g if isinstance(g, tuple) else (g.matrix, tuple(g.indices)))
        k = len(tgts)
        op = np.asarray(mat, np.complex128).reshape((2,) * (2 * k))
        psi = np.tensordot(op, psi, axes=(list(range(k, 2 * k)), list(tgts)))
        psi = np.moveaxis(psi, list(range(k)), list(tgts))
    return psi.reshape(-1)


def logical_amplitudes(sv) -> np.ndarray:
    re, im, axis_of = sv.to_numpy()
    amp = (re.astype(np.float64) + 1j * im).reshape((2,) * sv.N)
    return amp.transpose(axis_of).reshape(-1)


# -- the CV grid-MPS path ------------------------------------------------------
# Production settings of the GKP pipelines: d = 1000 on [-20, 20], 10 dB
# GKP states, bond cap 100 at rel_err 1e-2 (Q40: cap 40, the randomized SVD).
CV_QS = np.linspace(-20, 20, 1000)
CV_EPS = float(2 * np.arctanh(10 ** (-10 / 10) / 2))
CV_SEED = 7
CV_REPS = 3          # timed runs per circuit, after one warm-up
# complex64 vs complex128 limits per circuit, on 1 - fidelity and on each
# outcome's relative probability difference: 5-25x above the sound
# readings on an H100, and below those of a control (``cv_control``)
# wherever the control moves the circuit past that headroom; phase 7d
# checks that each control is caught. Q40's were reset when the range
# finder's Gram moved to complex128 (its reading fell from 3.5e-10 to
# 1.3e-14; PERF.md §6)
CV_FID_TOL = {"S": 1e-12, "Q": 1e-13, "T": 1e-11, "Q40": 1e-13}
CV_PROB_RTOL = {"S": 3e-6, "Q": 1e-5, "T": 3e-5, "Q40": 1e-5}
CV_NORM_TOL = 1e-3   # |norm - 1| after every gate that is not a measurement
CV_CPU_FID_TOL = 1e-8  # card complex128 vs CPU complex128 (S)
CV_TRACE_DIR = os.path.join("profile_traces", "cv")  # ignored by git


@contextlib.contextmanager
def x64_dtype():
    """QCT_X64=1 inside the block: the port's default dtype is complex128."""
    old = os.environ.get("QCT_X64")
    os.environ["QCT_X64"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["QCT_X64"]
        else:
            os.environ["QCT_X64"] = old


@contextlib.contextmanager
def patched(obj, attr: str, value):
    """``obj.attr`` = value inside the block."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def cv_circuit(name: str, cg, State, forced=()):
    """The gate list of circuit ``name``; ``forced`` gives the measurement
    outcomes in gate order (None: sampled)."""
    f = iter(forced)
    m = lambda: next(f, None)  # noqa: E731
    eps = CV_EPS

    def quadrature_correction():  # pipelines/cv_circuits.py:33-38
        return [cg.Insert(1, State.GKP_ZERO, gkp_epsilon=eps), cg.CZ(0, 1),
                cg.Mp(1, result=m())]

    if name == "S":  # Steane EC, pipelines/cv_circuits.py:41-47
        first = quadrature_correction()
        return [*first, cg.F(0, dagger=True), *quadrature_correction(),
                cg.F(0)]
    if name in ("Q", "Q40"):  # qunaught EC, pipelines/cv_circuits.py:19-30
        return [cg.Insert(1, State.QUNAUGHT, gkp_epsilon=eps),
                cg.Insert(2, State.QUNAUGHT, gkp_epsilon=eps),
                cg.BS(2, 1), cg.BS(1, 0), cg.Mq(0, result=m()),
                cg.Mp(0, result=m())]
    if name == "T":  # every gate class of cv/gates.py on three modes
        return [cg.Insert(0, State.GKP_ZERO, gkp_epsilon=eps),
                cg.Insert(1, State.GKP_PLUS, gkp_epsilon=eps),
                cg.Insert(2, State.GKP_T, gkp_epsilon=eps),
                cg.BS(0, 1), cg.CZ(1, 2), cg.CX(2, 1), cg.SWAP(0, 1),
                cg.F(0), cg.X(1, 0.3), cg.Z(2, 0.4), cg.D(0, [0.2, -0.3]),
                cg.P(1, 0.5), cg.S(2, 0.2, np.pi / 2), cg.Phase(0, np.pi / 3),
                cg.BS(1, 2, 0.3, dagger=True), cg.CX(0, 1, s=0.5),
                cg.Mq(2, result=m()), cg.Insert(2, State.VACUUM),
                cg.CZ(1, 2), cg.Homodyne(1, np.pi / 3, result=m()),
                cg.Mp(1, result=m())]
    raise ValueError(name)


def cv_initial(name: str, MPS, State, device: str):
    if name == "T":
        return MPS(CV_QS, [], device=device)
    return MPS(CV_QS, [State.GKP_H.eval(CV_QS, CV_EPS, device=device)])


def cv_options(name: str, SVDOptions):
    return SVDOptions(max_bond_dim=40 if name == "Q40" else 100, rel_err=1e-2)


def kept_ranks(mps) -> list[int]:
    """The kept rank of every bond: its nonzero columns (truncated
    directions are exact zeros)."""
    return [int((t.abs().sum(dim=(0, 1)) > 0).sum()) for t in mps.tensors[:-1]]


def cv_run(name: str, device="cuda", forced=(), check=False, profile_dir=None,
           snapshots=None):
    """One run of circuit ``name`` through ``cv.Simulator``. With ``check``,
    a per-gate hook holds |norm - 1| after every non-measurement gate and
    records the kept ranks and the largest contracted two-mode tensor;
    with ``snapshots`` (a list) it also keeps the state after every gate if
    the list is empty, else the fidelity to the state it holds there."""
    from quantum_computations_tpu_torch.config import SVDOptions
    from quantum_computations_tpu_torch.cv import MPS, Simulator, State
    from quantum_computations_tpu_torch.cv import gates as cg
    from quantum_computations_tpu_torch.cv import simulator as cv_sim

    gates = cv_circuit(name, cg, State, forced)
    info = {"norm_err": 0.0, "ranks": [], "largest_pair": 0,
            "gate_infidelity": []}
    keep = snapshots is not None and not snapshots

    def hook(sim):
        st = sim._state
        i = len(info["ranks"])
        info["ranks"].append(kept_ranks(st))
        if not isinstance(gates[i], cg.Measurement):
            err = abs(float(st.norm()) - 1.0)
            info["norm_err"] = max(info["norm_err"], err)
            if not err < CV_NORM_TOL:
                raise AssertionError(f"{name}: |norm - 1| = {err} after gate "
                                     f"{i} ({gates[i]})")
        if keep:
            snapshots.append(st.copy())
        elif snapshots is not None and len(st):
            info["gate_infidelity"].append(1 - cv_fidelity(snapshots[i], st))
        if i + 1 < len(gates) and isinstance(gates[i + 1], cg.TwoModeGate):
            g = gates[i + 1]
            a, d, _ = st[g.left_index].shape
            info["largest_pair"] = max(info["largest_pair"],
                                       a * d * d * st[g.right_index].shape[2])

    sim = Simulator(gates, rng_seed=CV_SEED, debug_info=hook,
                    svd_options=cv_options(name, SVDOptions))
    log_level = cv_sim.logger.level
    cv_sim.logger.setLevel(logging.DEBUG if check else logging.WARNING)
    try:
        mps = cv_initial(name, MPS, State, device)
        out = sim.run(mps, profile_dir=profile_dir)
    finally:
        cv_sim.logger.setLevel(log_level)
    if device == "cuda":
        torch.cuda.synchronize()
    info["gates"] = len(gates)
    info["outcomes"] = [r.result for r in sim.results]
    info["probabilities"] = [float(r.probability) for r in sim.results]
    if check and info["largest_pair"] > cg._STREAM_THRESHOLD:
        raise AssertionError(f"{name} asked for the streamed split")
    return out, info


def gram_svd_complex64(A):
    """Control: ``ops.linalg.svd_gram`` with its Gram formed and decomposed
    in A's dtype (complex64) instead of float64, its diagonal ramp scaled
    to float32 rounding; A may carry leading batch axes."""
    m, n = A.shape[-2:]
    if m < n:
        U, s, Vh = gram_svd_complex64(A.mH)
        return Vh.mH.resolve_conj(), s, U.mH.resolve_conj()
    G = A.mH @ A
    trace = G.diagonal(dim1=-2, dim2=-1).sum(-1).real
    G.diagonal(dim1=-2, dim2=-1).add_(
        torch.arange(n, dtype=G.real.dtype, device=G.device) * (1e-7 * trace / n**2)[..., None])
    w, V = torch.linalg.eigh(G)
    w, V = w.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = (A @ V) / torch.where(s > 0, s, torch.ones_like(s))[..., None, :]
    return U, s, V.mH.resolve_conj()


@contextlib.contextmanager
def cv_control(kind: str):
    """Inside the block the port computes in a precision it must not fall
    back to: "gram_c64", the SVD's Gram in complex64 on the card; or
    "tables_f32", every grid table of ``ops/interp`` (sinc, rotation
    kernel, CFT phase, CZ phase, shear coordinates) formed from a float32
    grid. The complex64-vs-complex128 limits must catch each of them."""
    from quantum_computations_tpu_torch.ops import interp, linalg
    if kind == "gram_c64":
        real = linalg.svd_compat
        with patched(linalg, "svd_compat", lambda A, full_matrices=False: (
                gram_svd_complex64(A) if A.is_cuda else real(A, full_matrices))):
            yield
    elif kind == "tables_f32":
        with patched(interp, "_f64", lambda x, like: torch.as_tensor(
                x, dtype=torch.float32, device=like.device)):
            yield
    else:
        raise ValueError(kind)


def c64_vs_c128(ref, ref_info, got, got_info) -> tuple[float, float]:
    """(1 - fidelity, max relative probability difference) of a complex64
    run against the complex128 run whose outcomes it forced."""
    fid = cv_fidelity(ref, got)
    prob_rel = max((abs(p - q) / q for p, q in
                    zip(got_info["probabilities"], ref_info["probabilities"])),
                   default=0.0)
    return 1 - fid, prob_rel


def cv_fidelity(a, b) -> float:
    """|<a|b>|^2 / (<a|a><b|b>) in complex128 on a's device."""
    from quantum_computations_tpu_torch.cv import MPS
    a = MPS(a.domain, a.tensors, device=a.device, dtype=torch.complex128)
    b = MPS(b.domain, b.tensors, device=a.device, dtype=torch.complex128)
    return float(MPS.fidelity(a, b) / (a.norm() ** 2 * b.norm() ** 2))


def trace_summary(trace_dir: str, prefix: str = "cv:") -> dict:
    """Device-busy share and per-class times of the newest
    ``torch.profiler`` trace in ``trace_dir``: the window runs from the
    first span whose name starts with ``prefix`` to the end of the last such span or
    device event; device time of a class sums the kernels, copies and
    fills launched inside its spans."""
    path = max((os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                if f.endswith(".json")), key=os.path.getmtime)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(prefix)), key=lambda e: e["ts"])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    if not spans or not device:
        raise AssertionError(f"the trace {path} holds {len(spans)} gate spans "
                             f"and {len(device)} device events")
    t0 = spans[0]["ts"]
    t1 = max(max(e["ts"] + e["dur"] for e in spans),
             max(e["ts"] + e["dur"] for e in device))
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if f > s:
            busy += f - s
            end = f
    per_class = {}
    for sp in spans:
        row = per_class.setdefault(sp["name"][len(prefix):],
                                   {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += sp["dur"] / 1e3
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        for sp in spans:
            if ts is not None and sp["ts"] <= ts <= sp["ts"] + sp["dur"]:
                per_class[sp["name"][len(prefix):]]["device_ms"] += e["dur"] / 1e3
                break
    return {"trace": path, "window_ms": (t1 - t0) / 1e3,
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / (t1 - t0),
            "per_class": per_class}


def count_syncs(fn) -> int:
    """Host syncs of ``fn()``, as torch's sync debug mode reports them
    (:func:`count_syncs_by_source`, summed)."""
    counts = count_syncs_by_source(fn)
    return counts["library"] + counts["other"]


def split_parts(name: str, k: int, forced, reference: bool) -> dict:
    """Gate ``k`` of circuit ``name`` (a two-mode gate) in its parts, on the
    complex64 state the circuit reaches there with ``forced`` outcomes: the
    contraction + grid transform, the port's SVD (``svd_compat``: float64
    Gram eigh on CUDA), and the truncation mask + bond trim (one host
    sync); and the host syncs of the whole split (``cv.gates._split``).
    With ``reference``, the rank-r products of ``svd_compat``, of
    cuSOLVER's ``torch.linalg.svd`` of the same complex64 matrix (also
    timed) and of the complex64-Gram control are held against
    LAPACK's complex128 SVD of that matrix on the CPU, r the kept rank."""
    from quantum_computations_tpu_torch.config import SVDOptions
    from quantum_computations_tpu_torch.cv import MPS, Simulator, State
    from quantum_computations_tpu_torch.cv import gates as cg
    from quantum_computations_tpu_torch.ops import interp, linalg

    gates = cv_circuit(name, cg, State, forced)
    opts = cv_options(name, SVDOptions)
    mps = Simulator(gates[:k], rng_seed=CV_SEED, svd_options=opts).run(
        cv_initial(name, MPS, State, "cuda"))
    gate = gates[k]
    t1, t2 = mps[gate.left_index], mps[gate.right_index]
    a, d, _ = t1.shape
    b = t2.shape[2]
    if isinstance(gate, cg.BS):
        params = ("rot", gate.arg * (-1) ** (gate.index1 > gate.index2)
                  * (-1) ** gate.dagger)
    elif isinstance(gate, cg.CZ):
        params = ("cz", (-1) ** gate.dagger * gate.arg)
    else:
        raise ValueError(f"{gate} is not a BS or a CZ")

    def contract_warp():
        return interp.affine_warp(mps.qs, torch.tensordot(t1, t2, dims=([2], [0])),
                                  params)

    m = contract_warp().reshape(a * d, d * b)
    split_syncs = count_syncs(
        lambda: cg._split(contract_warp(), (0, 1), (2, 3), opts, None))
    contract_ms = cuda_ms(contract_warp, 3)
    gram_ms = cuda_ms(lambda: linalg.svd_compat(m), 2)
    u, s, vh = linalg.svd_compat(m)
    cap = min(opts.max_bond_dim, a * d, d * b)

    def mask_trim():
        rank, mask = linalg.truncation_rank_mask(s, opts.max_bond_dim, 0.0,
                                                 opts.rel_err)
        sq = (torch.sqrt(s) * mask).to(u.dtype)
        return linalg.trim_split((u * sq[None, :])[:, :cap],
                                 (sq[:, None] * vh)[:cap], rank)

    mask_trim()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        mask_trim()
    torch.cuda.synchronize()
    trim_ms = (time.perf_counter() - t) / 3 * 1e3
    r = int(linalg.truncation_rank_mask(s, opts.max_bond_dim, 0.0, opts.rel_err)[0])
    parts = {"gate": f"{gate} (gate {k} of {name})", "matrix": [a * d, d * b],
             "dtype": str(m.dtype), "kept_rank": r,
             "contraction_warp_ms": contract_ms, "svd_compat_ms": gram_ms,
             "mask_trim_ms": trim_ms, "host_syncs_per_split": split_syncs}
    if not reference:
        return parts

    cusolver = torch.linalg.svd(m, full_matrices=False)  # warm-up; its error
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.linalg.svd(m, full_matrices=False)
    end.record()
    torch.cuda.synchronize()
    u0, s0, vh0 = torch.linalg.svd(m.cpu().to(torch.complex128),
                                   full_matrices=False)
    want = (u0[:, :r] * s0[:r]) @ vh0[:r]

    def trunc_err(u, s, vh) -> float:
        got = ((u[:, :r] * s[:r]) @ vh[:r]).cpu().to(torch.complex128)
        return float((got - want).norm() / want.norm())

    parts.update({
        "cusolver_svd_ms": start.elapsed_time(end),
        "svd_compat_trunc_rel_err": trunc_err(u, s, vh),
        "cusolver_trunc_rel_err": trunc_err(*cusolver),
        "gram_c64_control_trunc_rel_err": trunc_err(*gram_svd_complex64(m))})
    return parts


def cv_path() -> dict:
    from quantum_computations_tpu_torch.ops import linalg

    result = {"grid": [float(CV_QS[0]), float(CV_QS[-1]), len(CV_QS)],
              "epsilon": CV_EPS, "circuits": {}}
    for name in ("S", "Q", "T", "Q40"):
        with Phase(f"7 cv {name}"):
            randomized = 0
            real_rsvd = linalg.randomized_truncated_svd

            def counting_rsvd(*args, **kwargs):
                nonlocal randomized
                randomized += 1
                return real_rsvd(*args, **kwargs)

            linalg.randomized_truncated_svd = counting_rsvd
            try:
                snaps = []
                with x64_dtype():
                    ref, ref_info = cv_run(name, check=True, snapshots=snaps)
                forced = ref_info["outcomes"]
                got, got_info = cv_run(name, forced=forced, check=True,
                                       snapshots=snaps)
                del snaps
            finally:
                linalg.randomized_truncated_svd = real_rsvd
            if ref.dtype != torch.complex128 or got.dtype != torch.complex64:
                raise AssertionError(f"{name} ran in {ref.dtype}, {got.dtype}")
            loss, prob_rel = c64_vs_c128(ref, ref_info, got, got_info)
            fid = 1 - loss
            controls = {}
            for kind in ("gram_c64", "tables_f32"):
                try:
                    with cv_control(kind):
                        c_out, c_info = cv_run(name, forced=forced)
                except torch.linalg.LinAlgError as e:
                    # the control's decomposition failed: the smoke would
                    # stop on such a fallback, so it counts as caught
                    controls[kind] = {"raised": repr(e), "infidelity": 1.0,
                                      "max_rel_prob_diff": float("inf")}
                    continue
                c_loss, c_prob = c64_vs_c128(ref, ref_info, c_out, c_info)
                controls[kind] = {"infidelity": c_loss, "max_rel_prob_diff": c_prob}
                del c_out
            log(f"{name}: {got_info['gates']} gates; outcomes "
                f"{forced}; complex64 vs complex128: 1 - fidelity {loss:.3e}, "
                f"max rel prob diff {prob_rel:.2e}, max |norm - 1| "
                f"{ref_info['norm_err']:.2e} / {got_info['norm_err']:.2e}; "
                f"probabilities (c128) {ref_info['probabilities']}, (c64) "
                f"{got_info['probabilities']}; 1 - fidelity after each gate "
                f"{['%.1e' % x for x in got_info['gate_infidelity']]}; "
                f"kept ranks (c128) {ref_info['ranks']}; kept ranks (c64) "
                f"{got_info['ranks']}; largest pair "
                f"{got_info['largest_pair']} elements; randomized SVDs "
                f"{randomized}; limits: 1 - fidelity < {CV_FID_TOL[name]}, "
                f"probabilities within {CV_PROB_RTOL[name]}; controls "
                f"(1 - fidelity, max rel prob diff) {controls}")
            if ref_info["ranks"] != got_info["ranks"]:
                log(f"{name}: the kept ranks of the two runs differ")
            if not loss < CV_FID_TOL[name]:
                raise AssertionError(f"{name}: 1 - fidelity = {loss}")
            if not prob_rel < CV_PROB_RTOL[name]:
                raise AssertionError(f"{name}: probabilities differ by {prob_rel}")
            if (randomized > 0) != (name == "Q40"):
                raise AssertionError(f"{name} ran {randomized} randomized SVDs")

            run = lambda: cv_run(name, forced=forced)  # noqa: E731
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(CV_REPS):
                run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / CV_REPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            syncs = count_syncs(run)
            trace_dir = os.path.join(CV_TRACE_DIR, name)
            cv_run(name, forced=forced, profile_dir=trace_dir)
            trace = trace_summary(trace_dir)
            log(f"{name}: {ms:.3f} ms per circuit (complex64, forced outcomes,"
                f" mean of {CV_REPS}); host syncs per circuit {syncs}; "
                f"max_memory_allocated {peak:.2f} GiB; traced run: window "
                f"{trace['window_ms']:.3f} ms, device busy "
                f"{trace['device_busy_share']:.4f}; per gate class "
                f"{trace['per_class']}")
            result["circuits"][name] = {
                "gates": got_info["gates"],
                "ms_per_circuit": ms, "host_syncs": syncs,
                "max_memory_allocated_gib": peak,
                "fidelity_c64_vs_c128": fid, "max_rel_prob_diff": prob_rel,
                "controls": controls,
                "max_norm_err": max(ref_info["norm_err"], got_info["norm_err"]),
                "outcomes": forced, "ranks_c128": ref_info["ranks"],
                "ranks_c64": got_info["ranks"],
                "gate_infidelity_c64": got_info["gate_infidelity"],
                "largest_pair_elements": got_info["largest_pair"],
                "randomized_svds": randomized,
                "device_busy_share": trace["device_busy_share"],
                "traced_window_ms": trace["window_ms"],
                "per_gate_class": trace["per_class"]}
            if name == "S":
                ref_s = ref, ref_info

    with Phase("7b cv S: card complex128 vs CPU complex128"):
        cpu, cpu_info = cv_run("S", device="cpu")
        card, card_info = ref_s
        fid = cv_fidelity(cpu, card.copy())
        same = cpu_info["outcomes"] == card_info["outcomes"]
        log(f"S on the CPU (seed {CV_SEED}): outcomes {cpu_info['outcomes']}"
            f" (card {card_info['outcomes']}), fidelity to the card's "
            f"complex128 state {fid:.15f}")
        if not same:
            raise AssertionError("the seeded S drew other outcomes on the CPU")
        if not 1 - fid < CV_CPU_FID_TOL:
            raise AssertionError(f"S: card vs CPU 1 - fidelity = {1 - fid}")
        result["S_card_vs_cpu"] = {"same_outcomes": same, "fidelity": fid}

    with Phase("7c cv splits in parts: BS(1, 0) of Q, CZ(1, 2) of T"):
        result["splits"] = []
        for name, k, reference in (("Q", 3, True), ("T", 18, False)):
            parts = split_parts(name, k, result["circuits"][name]["outcomes"],
                                reference)
            log(f"split parts: {parts}")
            result["splits"].append(parts)

    with Phase("7d cv limits against the controls"):
        for kind in ("gram_c64", "tables_f32"):
            caught = [name for name, c in result["circuits"].items()
                      if not (c["controls"][kind]["infidelity"] < CV_FID_TOL[name]
                              and c["controls"][kind]["max_rel_prob_diff"]
                              < CV_PROB_RTOL[name])]
            log(f"control {kind}: outside the limits in {caught}")
            if not caught:
                raise AssertionError(f"the complex64 limits pass the {kind} "
                                     "control in every circuit")
    return result

# -- the eager GKP engine ------------------------------------------------------
# The GKP pipelines' settings (pipelines/rb_batched.py:201-204): d = 1000 on
# [-20, 20], 10 dB ancillas, bond cap 100 at rel_err 1e-2. G1 is the JAX
# package's two-qubit test circuit; G2 runs every gadget class, with the T
# gate's classically controlled P. At rel_err 1e-2 their bonds stay small
# (largest pair 4 x 1000 x 1000 x 8 on the CPU), so at the default
# threshold no split streams: the checks run with the threshold at 4 d^2,
# where the interior splits of each two-qubit gadget (a b > 4) stream.
GKP_SEED = 5
GKP_SWEEP = 8        # seeds of G1 run by both routes at the lowered threshold
GKP_REPS = 3         # timed circuits, after one warm-up
GKP_STREAM_THRESHOLD = 4 * len(CV_QS) ** 2
GKP_DV_FID_MIN = {"G1": 0.85}  # the JAX package's bound (tests/test_gkp.py)
# complex64 vs complex128 limits per (circuit, BS route) at GKP_SEED, on
# 1 - fidelity of the final MPS, max |rho_c64 - rho_c128| of the corrected
# logical density and each outcome's relative probability difference:
# between the sound reading and the tables_f32 control's on an H100 (near
# their geometric mean), None where the control reads under 1.5x the
# sound reading. The stream_gram_c64 control does not separate from the
# sound run. Over seeds the sound readings spread as far as this seed's
# control, so the limits hold this seed only (PERF.md §6)
GKP_LIMITS = {("G1", "rot"): (7e-8, 1.3e-4, 6e-5),
              ("G2", "rot"): (7.5e-8, 1.4e-4, 6e-5),
              ("G1", "cz"): (4e-8, 1e-4, None),
              ("G2", "cz"): (4.4e-7, 3.8e-4, None)}
GKP_TRACE_DIR = os.path.join("profile_traces", "gkp")  # ignored by git


def gkp_circuit(name: str, dvg) -> list:
    if name == "G1":
        return [dvg.H(0), dvg.CZ(0, 1), dvg.H(1)]
    return [dvg.H(0), dvg.CZ(0, 1), dvg.P(0), dvg.T(1), dvg.H(1), dvg.SWAP(0, 1)]


@contextlib.contextmanager
def gkp_tape(replay=None, orth_check=False):
    """Inside the block the port's homodyne outcomes and probabilities,
    its streamed-split and randomized-SVD sketches (float64, on the host)
    are recorded, or, with ``replay`` (an earlier tape), forced and
    replayed in the same order. Also counts the streamed splits (and the
    CZ splits they run), the largest a*d*d*b of any two-mode split, each
    streamed CZ split's (kept rank, cap, smallest kept s / largest), and
    with ``orth_check`` keeps the eigenvalues of Q^H Q (in float64) of
    every ``orthonormalize(method="ns")`` of the streamed splits."""
    from quantum_computations_tpu_torch.cv import gates as cg
    from quantum_computations_tpu_torch.ops import linalg, streamed

    tape = {"outcomes": [], "probabilities": [], "stream": [], "rsvd": [],
            "streamed_splits": 0, "cz_splits": 0, "largest_pair": 0,
            "orth_eigs": [], "split_ranks": []}
    it = (None if replay is None else
          {k: iter(replay[k]) for k in ("outcomes", "stream", "rsvd")})
    host = torch.empty(0, dtype=torch.float64)
    real = {"mq": cg.Mq.apply, "stream": streamed._stream_sketch,
            "rsvd": linalg._gaussian_sketch, "split": cg.streamed_pair_svd,
            "use": cg._use_streamed, "driver": streamed._streamed_driver,
            "orth": streamed.orthonormalize, "factor": streamed._host_factor}

    def mq(self, mps, **kw):
        if it is not None:
            self.result = next(it["outcomes"])
        out = real["mq"](self, mps, **kw)
        tape["outcomes"].append(out.result)
        tape["probabilities"].append(float(out.probability))
        return out

    def sketch(kind):
        def draw(*args):
            *shape_gen, like = args
            o = (next(it[kind]) if it is not None
                 else real[kind](*shape_gen, host))
            if it is None:
                tape[kind].append(o)
            return o.to(device=like.device, dtype=like.dtype)
        return draw

    def use(a, d, b, opts):
        tape["largest_pair"] = max(tape["largest_pair"], a * d * d * b)
        return real["use"](a, d, b, opts)

    def split(*args, **kw):
        tape["streamed_splits"] += 1
        return real["split"](*args, **kw)

    def driver(*args, **kw):
        tape["cz_splits"] += 1
        return real["driver"](*args, **kw)

    def factor(G, cap, *args):
        U, sqm, ism, rank = real["factor"](G, cap, *args)
        s = sqm[:max(rank, 1)] ** 2  # the kept singular values
        tape["split_ranks"].append((rank, cap, float(s[-1] / s[0])))
        return U, sqm, ism, rank

    def orth(Y, method="eigh"):
        Q = real["orth"](Y, method=method)
        if orth_check:
            Q64 = Q.to(torch.complex128)
            tape["orth_eigs"].append(torch.linalg.eigvalsh(Q64.mH @ Q64).cpu())
        return Q

    with contextlib.ExitStack() as stack:
        for obj, attr, new in (
                (cg.Mq, "apply", mq), (streamed, "_stream_sketch", sketch("stream")),
                (linalg, "_gaussian_sketch", sketch("rsvd")), (cg, "_use_streamed", use),
                (cg, "streamed_pair_svd", split), (streamed, "_streamed_driver", driver),
                (streamed, "orthonormalize", orth), (streamed, "_host_factor", factor)):
            stack.enter_context(patched(obj, attr, new))
        yield tape


def gkp_run(name: str, dtype=torch.complex64, seed=GKP_SEED):
    """One run of circuit ``name`` through the port's eager
    ``gkp.Simulator`` on the card: (final MPS, syndromes)."""
    from quantum_computations_tpu_torch import gkp
    from quantum_computations_tpu_torch.dv import State, gates as dvg

    circ = gkp.MBGKPCircuit.transpile(gkp_circuit(name, dvg))
    circ.fill()
    sim = gkp.Simulator(circ, ancilla_epsilon=CV_EPS, rng_seed=seed,
                        svd_options={"max_bond_dim": 100, "rel_err": 1e-2})
    out = sim.run(gkp.parse_to_mps([State.ZERO] * 2, CV_EPS, CV_QS,
                                   device="cuda", dtype=dtype))
    torch.cuda.synchronize()
    return out


def gkp_rho(mps, syndromes):
    """The syndrome-corrected, normalised logical density, read out in
    complex128."""
    from quantum_computations_tpu_torch import gkp
    from quantum_computations_tpu_torch.cv import MPS
    mps = MPS(mps.domain, mps.tensors, device=mps.device, dtype=torch.complex128)
    rho = gkp.full_logical_density_mps(mps)
    corr = gkp.syndrome_matrix(syndromes).to(rho.device, rho.dtype)
    rho = corr @ rho @ corr.mH
    return rho / torch.trace(rho)


def rho_diff(a, b) -> float:
    """max |a - b| of two logical densities. Their fidelity is not used:
    the readout's finite-squeezing densities are not positive
    semidefinite, so (tr sqrt(sqrt(a) b sqrt(a)))^2 is not bounded by 1."""
    return float((a - b).abs().max())


def max_rel_diff(got: list, want: list) -> float:
    return max(abs(p - q) / q for p, q in zip(got, want, strict=True))


def dv_fidelity(name: str, rho) -> float:
    """Fidelity of a logical density to the port's DV engine's state."""
    from quantum_computations_tpu_torch.dv import Simulator as DVSim, State, qop
    from quantum_computations_tpu_torch.dv import gates as dvg
    want = DVSim(gkp_circuit(name, dvg), device="cuda").run([State.ZERO] * 2)
    return float(qop.fidelity(want.to(torch.complex128), rho))


def gkp_timing(name: str, trace_dir: str | None = None) -> dict:
    """ms per circuit (complex64, seeded, mean of GKP_REPS after a
    warm-up), host syncs, peak memory, and with ``trace_dir`` a traced
    run's device-busy share, per-gadget-class and streamed-part times."""
    run = lambda: gkp_run(name)  # noqa: E731
    run()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(GKP_REPS):
        run()
    out = {"ms_per_circuit": (time.perf_counter() - t) / GKP_REPS * 1e3,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "host_syncs": count_syncs(run)}
    if trace_dir is not None:
        from quantum_computations_tpu_torch.utils import maybe_trace
        with maybe_trace(trace_dir):
            run()
        trace = trace_summary(trace_dir, prefix="gkp:")
        out.update({"device_busy_share": trace["device_busy_share"],
                    "traced_window_ms": trace["window_ms"],
                    "per_gadget_class": trace["per_class"],
                    "streamed_parts": trace_summary(trace_dir, prefix="streamed:")
                    ["per_class"]})
    return out


def gkp_check(name: str, decomp: str) -> dict:
    """Circuit ``name`` with the threshold at GKP_STREAM_THRESHOLD and the
    streamed BS split by ``decomp``: complex128 seeded, then complex64 and
    two complex64 controls (``stream_gram_c64``; ``tables_f32``, see
    :func:`cv_control`) with its outcomes and sketches replayed; each
    against complex128 and the DV state."""
    with stream_threshold(GKP_STREAM_THRESHOLD), bs_decomp(decomp):
        with x64_dtype(), gkp_tape() as ref_tape:
            ref, ref_syn = gkp_run(name, dtype=torch.complex128)
        with gkp_tape(ref_tape, orth_check=True) as tape:
            got, got_syn = gkp_run(name)
        with gkp_tape(ref_tape) as c_tape, stream_gram_c64():
            c_out, c_syn = gkp_run(name)
        with gkp_tape(ref_tape) as f_tape, cv_control("tables_f32"):
            f_out, f_syn = gkp_run(name)
    if ref.dtype != torch.complex128 or got.dtype != torch.complex64:
        raise AssertionError(f"{name} ran in {ref.dtype}, {got.dtype}")
    if min(tape["streamed_splits"], ref_tape["streamed_splits"]) < 1:
        raise AssertionError(f"{name} ran no streamed split")
    rho_ref = gkp_rho(ref, ref_syn)
    eigs = torch.cat(tape["orth_eigs"])
    out = {"syndromes": ref_syn, "homodynes": len(ref_tape["outcomes"]),
           "streamed_splits": tape["streamed_splits"], "cz_splits": tape["cz_splits"],
           "largest_pair": tape["largest_pair"],
           "streamed_ranks_c128": ref_tape["split_ranks"],
           "streamed_ranks_c64": tape["split_ranks"],
           "bonds": [t.shape[2] for t in got.tensors[:-1]],
           "ns_orthonormality": {
               "calls": len(tape["orth_eigs"]),
               "max_abs_eig_minus_1": float((eigs - 1).abs().max()),
               "share_of_eigs_within_1e-3_of_1":
                   float(((eigs - 1).abs() < 1e-3).double().mean())},
           "fidelity_to_dv": {"c128": dv_fidelity(name, rho_ref)}}
    for label, mps, syn, t in (("c64", got, got_syn, tape),
                               ("stream_gram_c64", c_out, c_syn, c_tape),
                               ("tables_f32", f_out, f_syn, f_tape)):
        rho = gkp_rho(mps, syn)
        out["fidelity_to_dv"][label] = dv_fidelity(name, rho)
        out[label] = {"infidelity": 1 - cv_fidelity(ref, mps),
                      "rho_max_abs_diff": rho_diff(rho_ref, rho),
                      "max_rel_prob_diff": max_rel_diff(t["probabilities"],
                                                        ref_tape["probabilities"])}
    limits = GKP_LIMITS.get((name, decomp))
    log(f"{name}, BS split {decomp}: {out}; limits (1 - fidelity, max |rho "
        f"diff|, max rel prob diff): {limits}")
    if name in GKP_DV_FID_MIN and not min(out["fidelity_to_dv"].values()) > GKP_DV_FID_MIN[name]:
        raise AssertionError(f"{name}: fidelity to the DV state {out['fidelity_to_dv']}")
    if limits is not None:
        def inside(reading):
            return all(limit is None or value < limit
                       for value, limit in zip(reading.values(), limits))
        if not inside(out["c64"]):
            raise AssertionError(f"{name}, {decomp}: complex64 vs complex128 "
                                 f"{out['c64']} outside {limits}")
        out["caught"] = {c: not inside(out[c]) for c in ("stream_gram_c64", "tables_f32")}
    return out


def gkp_path() -> dict:
    result = {"grid": [float(CV_QS[0]), float(CV_QS[-1]), len(CV_QS)],
              "epsilon": CV_EPS, "max_bond_dim": 100, "rel_err": 1e-2,
              "stream_threshold": GKP_STREAM_THRESHOLD, "circuits": {}}
    for name in ("G1", "G2"):
        with Phase(f"8 gkp {name}"):
            checks = {decomp: gkp_check(name, decomp) for decomp in ("cz", "rot")}
            with stream_threshold(GKP_STREAM_THRESHOLD):
                streamed_t = gkp_timing(name, os.path.join(GKP_TRACE_DIR, name))
            with gkp_tape() as default_tape:
                gkp_run(name)
            default_t = gkp_timing(name)
            log(f"{name} (complex64, seed {GKP_SEED}), threshold "
                f"{GKP_STREAM_THRESHOLD}: {streamed_t}; default threshold "
                f"(streamed splits {default_tape['streamed_splits']}, largest "
                f"pair {default_tape['largest_pair']}): {default_t}")
            result["circuits"][name] = {
                "checks": checks, "timing_streamed": streamed_t,
                "timing_default_threshold": default_t,
                "default_threshold_streamed_splits": default_tape["streamed_splits"],
                "default_threshold_largest_pair": default_tape["largest_pair"]}

    caught = {c: [f"{n} {decomp}" for n, r in result["circuits"].items()
                  for decomp, check in r["checks"].items() if check["caught"][c]]
              for c in ("stream_gram_c64", "tables_f32")}
    log(f"controls outside the complex64 limits: {caught}")
    if not caught["tables_f32"]:
        raise AssertionError("the complex64 limits pass the tables_f32 control "
                             "in every circuit")

    with Phase(f"8 gkp G1 over {GKP_SWEEP} seeds, both BS routes"):
        result["G1_seed_sweep"] = gkp_seed_sweep()

    with Phase("8b one streamed split against the materialised split"):
        result["split"] = streamed_split_check()
    with Phase("8c one streamed split of 10^10 elements"):
        result["large_split"] = large_split_check()
    return result


def gkp_seed_sweep() -> dict:
    """G1 over seeds 0..GKP_SWEEP-1 with the threshold at
    GKP_STREAM_THRESHOLD, by both BS routes: complex128 seeded, then
    complex64 with its outcomes and sketches replayed. Prints the
    complex64 readings against complex128 and both runs' fidelity to the DV
    state, which must exceed the JAX test's bound in every run."""
    rows = {}
    with stream_threshold(GKP_STREAM_THRESHOLD):
        for decomp in ("rot", "cz"):
            for seed in range(GKP_SWEEP):
                with bs_decomp(decomp):
                    with x64_dtype(), gkp_tape() as ref_tape:
                        ref, ref_syn = gkp_run("G1", dtype=torch.complex128, seed=seed)
                    with gkp_tape(ref_tape) as tape:
                        got, got_syn = gkp_run("G1", seed=seed)
                if min(tape["streamed_splits"], ref_tape["streamed_splits"]) < 1:
                    raise AssertionError(f"G1, seed {seed}, {decomp}: no streamed split")
                rho_ref, rho = gkp_rho(ref, ref_syn), gkp_rho(got, got_syn)
                rows[f"{decomp}:{seed}"] = {
                    "streamed_ranks": [r[0] for r in ref_tape["split_ranks"]],
                    "streamed_ranks_c64": [r[0] for r in tape["split_ranks"]],
                    "infidelity": 1 - cv_fidelity(ref, got),
                    "rho_max_abs_diff": rho_diff(rho_ref, rho),
                    "max_rel_prob_diff": max_rel_diff(tape["probabilities"],
                                                      ref_tape["probabilities"]),
                    "fidelity_to_dv": {"c128": dv_fidelity("G1", rho_ref),
                                       "c64": dv_fidelity("G1", rho)}}
    log(f"G1 seeds 0..{GKP_SWEEP - 1} at threshold {GKP_STREAM_THRESHOLD} "
        f"(complex64 vs complex128, fidelity to the DV state): {rows}")
    for key, row in rows.items():
        if not min(row["fidelity_to_dv"].values()) > GKP_DV_FID_MIN["G1"]:
            raise AssertionError(f"G1 {key}: fidelity to the DV state {row}")
    worst = {decomp: {m: max(r[m] for k, r in rows.items() if k.startswith(decomp))
                      for m in ("infidelity", "rho_max_abs_diff", "max_rel_prob_diff")}
             for decomp in ("rot", "cz")}
    log(f"G1 seed sweep, worst complex64 reading per route: {worst}")
    return {"runs": rows, "worst": worst}


def stream_gram_c64():
    """Control: the streamed split's Gram formed in complex64 (then cast)
    instead of complex128."""
    from quantum_computations_tpu_torch.ops import streamed
    return patched(streamed, "_gram", lambda Xm: (Xm.mH @ Xm).to(torch.complex128))


def streamed_threshold() -> int:
    from quantum_computations_tpu_torch.cv import gates as cg
    return cg._STREAM_THRESHOLD


def stream_threshold(value: int):
    from quantum_computations_tpu_torch.cv import gates as cg
    return patched(cg, "_STREAM_THRESHOLD", value)


def bs_decomp(decomp: str):
    from quantum_computations_tpu_torch.ops import streamed
    return patched(streamed, "_BS_DECOMP", decomp)


def hermite_basis(qs: np.ndarray, n: int) -> np.ndarray:
    """The first n grid-normalised Hermite functions (n, d), float64."""
    h = np.zeros((n, len(qs)))
    h[0] = np.pi ** -0.25 * np.exp(-qs ** 2 / 2)
    if n > 1:
        h[1] = np.sqrt(2) * qs * h[0]
    for k in range(2, n):
        h[k] = np.sqrt(2 / k) * qs * h[k - 1] - np.sqrt((k - 1) / k) * h[k - 2]
    return h * np.sqrt((qs[1] - qs[0]))


def smooth_pair(a: int, k: int, b: int, seed: int, n: int = 12):
    """(t1 (a, d, k), t2 (k, d, b)) on the card in complex64: smooth modes
    of the first n grid Hermite functions with a geometric spectrum,
    scaled so that ||t1 . t2|| = 1."""
    rng = np.random.default_rng(seed)
    h = hermite_basis(CV_QS / 1.5, n)
    w = 0.5 ** np.arange(n)
    cplx = lambda *s: rng.normal(size=s) + 1j * rng.normal(size=s)  # noqa: E731
    t1 = np.einsum("an,ni,nk->aik", cplx(a, n), h, w[:, None] * cplx(n, k))
    t2 = np.einsum("kn,nj,nb->kjb", cplx(k, n), h, w[:, None] * cplx(n, b))
    # ||t1 . t2||^2 = sum_kl (x_k^H x_l)(y_k^H y_l), x_k = t1[..., k], y_k = t2[k]
    x, y = t1.reshape(-1, k), t2.reshape(k, -1)
    norm = np.sqrt(np.sum((x.conj().T @ x) * (y.conj() @ y.T)).real)
    return tuple(torch.from_numpy(t / np.sqrt(norm)).to("cuda", torch.complex64)
                 for t in (t1, t2))


def large_split_check() -> dict:
    """One streamed BS split far above the threshold, where the streamed
    path exists for: a = b = k = 100 at d = 1000, 10^10 elements (80 GB
    as a complex64 matrix), built like 8b's. Each route once, after a
    warm-up of the three-CZ route: ms, peak memory above the inputs and
    the reconstruction error, computed without forming A as
    ||A - M||^2 = ||A||^2 - 2 Re tr(m2 A^H m1) + ||M||^2, M = m1 m2, with
    ||A|| = ||t1 . t2|| = 1 (the warp is unitary) and A^H m1 from one
    block-streamed sweep of the rotation."""
    from quantum_computations_tpu_torch.config import full_fp32_matmul
    from quantum_computations_tpu_torch.ops import streamed

    a = k = b = 100
    d = len(CV_QS)
    T1, T2 = smooth_pair(a, k, b, seed=9)
    qs = torch.as_tensor(CV_QS, dtype=torch.float64, device="cuda")
    warp = ("rot", np.pi / 4)
    mbd, rel_err = 100, 1e-2
    if not a * d * d * b > streamed_threshold():
        raise AssertionError("the 8c split is not above the stream threshold")
    _, mm_AH = streamed._sweep_fns(qs, warp, (a, d, k, b),
                                   streamed._pick_chunks(a, d, b), torch.complex64)
    q = streamed.effective_power_iters(7)

    def stream(decomp):
        with bs_decomp(decomp):
            return streamed.streamed_pair_svd(
                T1, T2, qs, warp, max_bond_dim=mbd, abs_err=0.0, rel_err=rel_err,
                generator=torch.Generator().manual_seed(3), power_iters=q)

    out = {"shape": [a, d, k, b], "elements": a * d * d * b,
           "matrix_gib_complex64": a * d * d * b * 8 / 2**30, "power_iters": q}
    stream("cz")
    for decomp in ("cz", "rot"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m1, m2, rank = stream(decomp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        cap = m1.shape[-1]
        with full_fp32_matmul():
            Z = mm_AH(T1, T2, m1.reshape(a * d, cap)).reshape(d * b, cap)
            M1, M2 = (m.to(torch.complex128) for m in (m1.reshape(a * d, cap),
                                                       m2.reshape(cap, d * b)))
            m_norm2 = torch.trace((M1.mH @ M1) @ (M2 @ M2.mH)).real
            cross = torch.trace(M2 @ Z.to(torch.complex128)).real
        err2 = float(1.0 - 2 * cross + m_norm2)
        out[decomp] = {"rank": rank, "ms": ms, "peak_gib_above_inputs": peak,
                       "reconstruction_err": float(np.sqrt(max(err2, 0.0))),
                       "err_squared": err2}
        del m1, m2, Z, M1, M2
    log(f"8c split: {out}")
    for decomp in ("cz", "rot"):
        r = out[decomp]
        if not (r["rank"] > 0 and np.isfinite(r["err_squared"])
                and r["peak_gib_above_inputs"] < 0.1 * out["matrix_gib_complex64"]):
            raise AssertionError(f"8c: {decomp} {r}")
    return out


def streamed_split_check() -> dict:
    """A BS split just under the stream threshold, a = 64, b = 4, d = 1000
    (2.56e8 elements, smooth modes with a geometric spectrum), streamed
    (forced) and materialised (``svd_gram``, float64 Gram) on the card in
    complex64, at the default power-iteration count. The JAX test's
    criteria gate the direct split (``_BS_DECOMP = "rot"``, as the JAX
    test pins it): reconstruction error within 1.5x the dropped singular
    mass of the exact split, kept s^2 within 1e-2. The three-CZ route
    truncates three times, so it is held to the first criterion only and
    its kept s^2 are printed. Then both routes' times, the parts of the
    default (direct) route, and the orthonormality of
    ``orthonormalize(method="ns")`` on this split's sketch product in
    complex64 and in complex128."""
    from quantum_computations_tpu_torch.cv import gates as cg
    from quantum_computations_tpu_torch.ops import interp, linalg, streamed
    from quantum_computations_tpu_torch.utils import maybe_trace

    a, k, b = 64, 8, 4
    d = len(CV_QS)
    T1, T2 = smooth_pair(a, k, b, seed=8)
    qs = torch.as_tensor(CV_QS, dtype=torch.float64, device="cuda")
    warp = ("rot", np.pi / 4)
    mbd, rel_err = 100, 1e-2
    if a * d * d * b > cg._STREAM_THRESHOLD:
        raise AssertionError("the 8b split is above the stream threshold")
    cap = min(mbd, a * d, d * b)
    q = streamed.effective_power_iters(7 if cap + 10 < 0.1 * min(a * d, d * b) else 4)

    def stream(decomp="rot"):
        with bs_decomp(decomp):
            return streamed.streamed_pair_svd(
                T1, T2, qs, warp, max_bond_dim=mbd, abs_err=0.0,
                rel_err=rel_err, generator=torch.Generator().manual_seed(1),
                power_iters=q)

    def materialise():
        A = interp.affine_warp(qs, torch.tensordot(T1, T2, dims=1), warp)
        return A.reshape(a * d, d * b)

    A = materialise()
    s64 = linalg.svd_gram(A)[1].double().cpu().numpy()
    out = {"shape": [a, d, k, b], "elements": a * d * d * b, "power_iters": q,
           "materialised_rank": int(linalg.truncation_rank_mask(
               torch.from_numpy(s64), mbd, 0.0, rel_err)[0])}
    for decomp in ("rot", "cz"):
        m1, m2, rank = stream(decomp)
        full = m1.reshape(a * d, cap) @ m2.reshape(cap, d * b)
        err = float(torch.linalg.vector_norm((full - A).to(torch.complex128)))
        del full
        dropped = float(s64[rank:].sum())
        kept = np.sort(torch.linalg.vector_norm(m1.reshape(a * d, cap), dim=0)
                       .double().cpu().numpy())[::-1][:rank] ** 2
        out[decomp] = {"rank": rank, "reconstruction_err": err,
                         "dropped_mass": dropped, "err_over_dropped": err / dropped,
                         "kept_s2_max_rel_diff": float(np.max(
                             np.abs(kept - s64[:rank]) / s64[:rank]))}

    # orthonormalize("ns") on this split's A @ O, complex64 and complex128
    O = torch.randn(d * b, cap + linalg.OVERSAMPLE, generator=torch.Generator()
                    .manual_seed(2), dtype=torch.float64).to("cuda", torch.complex64)
    Y = A @ O
    out["ns_orthonormality"] = {}
    for label, Yx in (("complex64", Y), ("complex128", Y.to(torch.complex128))):
        Q = linalg.orthonormalize(Yx, method="ns").to(torch.complex128)
        e = torch.linalg.eigvalsh(Q.mH @ Q)
        out["ns_orthonormality"][label] = {
            "max_abs_eig_minus_1": float((e - 1).abs().max()),
            "eigs_within_1e-3_of_1": int(((e - 1).abs() < 1e-3).sum()),
            "of": int(e.numel())}
    del Y, O, A

    out["rot_ms"] = cuda_ms(stream, 3)
    out["cz_ms"] = cuda_ms(lambda: stream("cz"), 3)
    out["materialised_ms"] = cuda_ms(lambda: linalg.svd_gram(materialise()), 2)
    trace_dir = os.path.join(GKP_TRACE_DIR, "split")
    with maybe_trace(trace_dir):
        stream()
    out["rot_parts"] = trace_summary(trace_dir, prefix="streamed:")["per_class"]
    log(f"8b split: {out}")
    for decomp in ("rot", "cz"):
        crit = out[decomp]
        if not crit["reconstruction_err"] <= 1.5 * crit["dropped_mass"] + 1e-6:
            raise AssertionError(f"8b: {decomp} reconstruction error {crit}")
    if not out["rot"]["kept_s2_max_rel_diff"] <= 1e-2:
        raise AssertionError(f"8b: kept s^2 {out['rot']}")
    return out


# -- the batched GKP trajectory engine -------------------------------------
# bench.py's production workload (bench.py:80-96, pipelines/rb_batched.py):
# the depth-8 two-qubit RB circuit random_circ(2, 8, default_rng(123)) at
# d = 1000 on [-20, 20], 10 dB, chi = 100, rel_err 1e-2, 16 trajectories,
# through BatchedGKP's production defaults (op granularity, adaptive trims,
# fused single and pair gadgets, host rank tracking).
RB_DEPTH = 8
RB_BATCH = 16
RB_CIRCUIT_SEED = 123
RB_SEED = 0
RB_FID_MIN = 0.5       # mean fidelity to the DV state of the timed batch
RB_TPU_CELL = ("round-5 TPU dataset, 10 dB depth 8: fused engine 0.9082 "
               "(SE 0.0141, n = 112, benchmarks/gkp_rb_fused_10.0_d8.dat.meta.json), "
               "reference 0.8783 (n = 200, benchmarks/gkp_rb_tpu_summary.json)")
# complex64 vs complex128 limits of one replayed trajectory (9c): 1 -
# fidelity of the final state, max |rho_c64 - rho_c128| of the corrected
# logical density and the largest relative difference of a drawn bin's
# probability. On an H100 the sound readings were 4.7e-13, 7.9e-7, 8.3e-7;
# the tables_f32 control's 2.4e-13, 5.5e-7, 4.7e-6 and the env_c64
# control's 3.8e-13, 4.7e-7, 9.8e-7 (PERF.md §6). Only the probability
# separates (tables_f32), so its limit sits near the geometric mean and
# must catch that control; the other two are ~20x the sound reading, the
# rule of the CV limits where no control separates.
RB_LIMITS = (1e-11, 1.5e-5, 2e-6)
RB_TRACE_DIR = os.path.join("profile_traces", "rb")  # ignored by git


def rb_workload():
    """(DV gates, transpiled circuit, engine) of bench.py's workload."""
    from quantum_computations_tpu_torch.pipelines.rb import random_circ
    dv_circ, gkp_circ = random_circ(2, RB_DEPTH, np.random.default_rng(RB_CIRCUIT_SEED))
    return dv_circ, gkp_circ, rb_engine()


def rb_run(runner, gkp_circ, batch=RB_BATCH, seed=RB_SEED, coeffs=None):
    """One batch of trajectories and its readout: (tensors, frames, rho
    (complex128 numpy, raw)); ``coeffs`` default to |0>|0>."""
    from quantum_computations_tpu_torch.dv import State
    from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
    if coeffs is None:
        coeffs = logical_coeffs([State.ZERO] * 2)
    tensors, frames = runner.run_circuit(gkp_circ, coeffs, batch, rng_seed=seed)
    re, im = runner.readout(tensors, frames)
    rho = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
    return tensors, frames, rho


@contextlib.contextmanager
def randomized_passes():
    """Inside the block, the list yielded gets (trajectories, Gram side)
    of every randomized split pass (``linalg.randomized_truncated_svd``
    call)."""
    from quantum_computations_tpu_torch.ops import linalg
    passes = []
    rsvd = linalg.randomized_truncated_svd

    def counted(A, k, *args, **kwargs):
        passes.append((int(np.prod(A.shape[:-2])),
                       min(k + linalg.OVERSAMPLE, *A.shape[-2:])))
        return rsvd(A, k, *args, **kwargs)

    with patched(linalg, "randomized_truncated_svd", counted):
        yield passes


@contextlib.contextmanager
def largest_inputs():
    """Inside the block the inputs of the largest fused single gadget and
    of the largest fused pair measure (by bond product) that the engine
    runs are kept: {"single": (args, a*k), "pair": (args, a*c)}."""
    from quantum_computations_tpu_torch.gkp import batched
    kept = {}
    real = {"single": batched.fused_single_gadget, "pair": batched.fused_pair_measure2}

    def keep(kind):
        def call(tensors, i, *args, **kw):
            size = tensors[i].shape[1] * tensors[i + (kind == "pair")].shape[-1]
            if size > kept.get(kind, (None, -1))[1]:
                kept[kind] = ((list(tensors), i) + args[:-1], size)
            return real[kind](tensors, i, *args, **kw)
        return call

    with patched(batched, "fused_single_gadget", keep("single")), \
            patched(batched, "fused_pair_measure2", keep("pair")):
        yield kept


@contextlib.contextmanager
def largest_streamed_split():
    """Inside the block the inputs of the largest streamed BS split (by
    bond product) that the batched engine runs are kept: {"args": (t1,
    t2, angle), "size": a*b}."""
    from quantum_computations_tpu_torch.gkp import compiled
    kept, real = {}, compiled.streamed_pair_svd_batched

    def keep(t1, t2, q, warp, **kw):
        if t1.shape[1] * t2.shape[-1] > kept.get("size", 0):
            kept.update(size=t1.shape[1] * t2.shape[-1], args=(t1, t2, warp[1]))
        return real(t1, t2, q, warp, **kw)

    with patched(compiled, "streamed_pair_svd_batched", keep):
        yield kept


@contextlib.contextmanager
def rb_tape(replay=None):
    """Inside the block the fused gadgets' and homodynes' drawn indices and
    the split sketches are recorded (on the host), or with ``replay`` (an
    earlier tape) replayed in the same order; either way each draw's
    probability (its bin of the distribution) is kept."""
    from quantum_computations_tpu_torch.gkp import compiled
    from quantum_computations_tpu_torch.ops import fused_gadget as fg, linalg, streamed
    tape = {"draw": [], "rsvd": [], "stream": [], "prob": []}
    it = None if replay is None else {k: iter(replay[k]) for k in ("draw", "rsvd", "stream")}
    real = {"draw": fg._draw, "rsvd": linalg._gaussian_sketch,
            "stream": streamed._stream_sketch}
    host = torch.empty(0, dtype=torch.float64)

    def draw(dist, forced, generator):
        if it is not None:
            idx = next(it["draw"]).to(dist.device)
        else:
            idx = real["draw"](dist, forced, generator)
            tape["draw"].append(idx.cpu())
        tape["prob"].append(fg._at(dist, idx).double().cpu())
        return idx

    def sketch(kind):
        def call(*args):
            *shape_gen, like = args
            o = next(it[kind]) if it is not None else real[kind](*shape_gen, host)
            if it is None:
                tape[kind].append(o)
            return o.to(device=like.device, dtype=like.dtype)
        return call

    with patched(fg, "_draw", draw), patched(compiled, "_draw", draw), \
            patched(linalg, "_gaussian_sketch", sketch("rsvd")), \
            patched(streamed, "_stream_sketch", sketch("stream")):
        yield tape


@contextlib.contextmanager
def rb_control():
    """Control: every grid table of the fused gadgets (the stretched sinc
    sampling matrices, Fourier phases, rotation kernels) and of
    ``ops/interp`` formed from a float32 grid."""
    from quantum_computations_tpu_torch.ops import fused_gadget as fg, interp
    from quantum_computations_tpu_torch.config import to_device
    with patched(fg, "_grid", lambda qs, device: to_device(
            np.asarray(qs, np.float32).astype(np.float64), device)), \
            cv_control("tables_f32"):
        yield


@contextlib.contextmanager
def env_c64():
    """Control: the fused gadgets' chain environments (and so their
    Newton-Schulz square roots) in the working dtype, complex64, the JAX
    package's form, instead of complex128."""
    from quantum_computations_tpu_torch.ops import fused_gadget as fg

    def left(tensors, like):
        res = like.new_ones((like.shape[0], 1, 1))
        for t in tensors:
            res = torch.einsum("zab,zaci,zbcj->zij", res, t, t.conj())
        return res

    def right(tensors, like):
        res = like.new_ones((like.shape[0], 1, 1))
        for t in reversed(tensors):
            res = torch.einsum("zica,zjcb,zab->zij", t, t.conj(), res)
        return res

    with patched(fg, "_left_env", left), patched(fg, "_right_env", right):
        yield


def rb_state_fidelity(a, b, qs) -> float:
    """|<a|b>|^2 / (<a|a><b|b>) of two one-trajectory batched chains on
    the grid ``qs``, in complex128."""
    from quantum_computations_tpu_torch.cv import MPS
    return cv_fidelity(MPS(qs, [t[0] for t in a]), MPS(qs, [t[0] for t in b]))


def fused_at_width(kept) -> dict:
    """9a: the largest fused single gadget and pair measure of the run, at
    its batch, in complex128 (drawn) and complex64 (forced to those
    indices), the pair by each of its four paths (gram on): the complex64
    outputs against complex128, ms per call (complex64, after a warm-up)
    and peak memory."""
    from quantum_computations_tpu_torch.ops import fused_gadget as fg
    out = {}
    cases = {"single": (fg.fused_single_gadget, kept["single"][0], {})}
    pair_args = kept["pair"][0]
    for path, (a1, a2, prerot) in {"a1zero": (0.0, np.arctan(2), True),
                                   "swapped": (-np.pi / 2, 0.0, True),
                                   "prerot": (np.arctan(2), -np.arctan(2), True),
                                   "exact": (np.arctan(2), -np.arctan(2), False)}.items():
        cases[f"pair[{path}]"] = (fg.fused_pair_measure2,
                                  pair_args[:3] + (float(a1), float(a2)),
                                  {"prerot": prerot, "gram": True})
    for name, (fn, args, kw) in cases.items():
        tensors, rest = args[0], args[1:]
        if name == "single":  # bell vectors in the chain's dtype
            rest = rest[:2] + (rest[2].to(torch.complex128),) + rest[3:]
        t128 = [t.to(torch.complex128) for t in tensors]
        ref = fn(t128, *rest, torch.Generator().manual_seed(9), diagnostics=True, **kw)
        force = (ref[3]["i"], ref[3]["j"])
        if ref[3].get("swapped"):
            force = force[::-1]
        t64 = [t.to(torch.complex64) for t in tensors]
        rest64 = rest if name != "single" else rest[:2] + (rest[2].to(torch.complex64),) + rest[3:]
        call = lambda: fn(t64, *rest64, force=force, diagnostics=True, **kw)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        errs = [float((g.to(torch.complex128) - r).abs().max() / r.abs().max())
                for g, r in zip(got[0], ref[0])]
        p_err = max(float(((got[3][k].double() - ref[3][k]).abs() / ref[3][k]).max())
                    for k in ("p1", "p2"))
        shape = [tuple(x.shape) for x in tensors]
        out[name] = {"chain": shape, "ms_per_call": ms, "peak_gib_above_inputs": peak,
                     "max_rel_tensor_err_c64": max(errs), "max_rel_prob_err_c64": p_err}
        log(f"9a {name} on {shape}: {ms:.3f} ms per call (batch {shape[0][0]}), "
            f"peak {peak:.3f} GiB above its inputs; complex64 vs complex128: "
            f"max rel tensor err {max(errs):.3e}, max rel prob err {p_err:.3e}")
        if not max(errs) < 1e-3:
            raise AssertionError(f"9a {name}: complex64 off by {max(errs)}")
    return out


REPLAY_CONTROLS = {"env_c64": env_c64, "tables_f32": rb_control,
                   "gram_c64": lambda: cv_control("gram_c64")}


def c64_vs_c128_replayed(run, qs, limits, label: str,
                         controls=("env_c64", "tables_f32"), must_catch="tables_f32") -> dict:
    """One trajectory by ``run()`` -> (tensors, frames, rho) in complex128
    (drawn), then in complex64 and in complex64 under each control with its
    indices and sketches replayed: 1 - fidelity of the final state, max
    |rho diff| of the corrected logical density, the largest relative
    difference of a drawn bin's probability, frames equal. The complex64
    readings must lie inside ``limits`` and those of the control
    ``must_catch`` outside them; with ``limits`` None the readings are only
    reported."""
    with x64_dtype(), rb_tape() as tape:
        ref_t, ref_f, ref_rho = run()
    out = {"draws": len(tape["draw"]), "sketches": len(tape["rsvd"]) + len(tape["stream"])}
    for name in ("c64",) + tuple(controls):
        ctx = contextlib.nullcontext() if name == "c64" else REPLAY_CONTROLS[name]()
        with rb_tape(tape) as c_tape, ctx:
            t, f, rho = run()
        if t[0].dtype != torch.complex64 or ref_t[0].dtype != torch.complex128:
            raise AssertionError(f"{label} ran {t[0].dtype} against {ref_t[0].dtype}")
        out[name] = {"infidelity": 1 - rb_state_fidelity(ref_t, t, qs),
                     "rho_max_abs_diff": float(np.abs(rho - ref_rho).max()),
                     "max_rel_prob_diff": max_rel_diff(
                         [float(p) for p in torch.cat(c_tape["prob"])],
                         [float(p) for p in torch.cat(tape["prob"])]),
                     "frames_equal": bool((np.asarray(f) == np.asarray(ref_f)).all())}
    log(f"{label} one trajectory, complex64 vs complex128 (indices and sketches "
        f"replayed): {out}; limits (1 - fidelity, max |rho diff|, max rel "
        f"prob diff): {limits}")
    if limits is None:
        return out
    if not out["c64"]["frames_equal"]:
        raise AssertionError(f"{label}: complex64 frames differ from complex128")

    def inside(r):
        return all(r[k] < limit for k, limit in zip(
            ("infidelity", "rho_max_abs_diff", "max_rel_prob_diff"), limits))

    if not inside(out["c64"]):
        raise AssertionError(f"{label}: complex64 {out['c64']} outside {limits}")
    out["caught"] = {c: not inside(out[c]) for c in controls}
    if not out["caught"][must_catch]:
        raise AssertionError(f"{label}: the {must_catch} control {out[must_catch]} "
                             f"passes the limits {limits}")
    return out


def rb_engine(qs=None, epsilon=None, max_bond_dim=100):
    """BatchedGKP in its production configuration on the card (default:
    the CV grid and 10 dB)."""
    from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
    return BatchedGKP(CV_QS if qs is None else qs, CV_EPS if epsilon is None else epsilon,
                      {"rel_err": 1e-2, "max_bond_dim": max_bond_dim},
                      adaptive=True, granularity="op", device="cuda")


def trajectory_c64_vs_c128(gkp_circ) -> dict:
    """9c: one trajectory of the RB circuit, complex64 and two controls
    against complex128 (:func:`c64_vs_c128_replayed`)."""
    return c64_vs_c128_replayed(
        lambda: rb_run(rb_engine(), gkp_circ, batch=1, seed=RB_SEED + 1),
        CV_QS, RB_LIMITS, "9c")


def streamed_routes(kept_split) -> dict:
    """9d: the run's largest streamed split by both BS routes: ms and kept
    ranks."""
    from quantum_computations_tpu_torch.ops import streamed
    t1, t2, angle = kept_split
    q = torch.as_tensor(CV_QS, dtype=torch.float64, device="cuda")
    out = {"pair": [int(t1.shape[1]), int(t2.shape[-1])]}
    for route in ("rot", "cz"):
        with bs_decomp(route):
            gen = torch.Generator().manual_seed(3)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, ranks = streamed.streamed_pair_svd_batched(
                t1, t2, q, ("rot", angle), max_bond_dim=100, abs_err=0.0,
                rel_err=1e-2, generator=gen, power_iters=streamed.effective_power_iters(4))
            torch.cuda.synchronize()
            out[route] = {"ms": (time.perf_counter() - t) * 1e3, "ranks": ranks.tolist()}
    log(f"9d the largest streamed split by route: {out}")
    return out


def rb_path() -> dict:
    """Phase 9: bench.py's workload through BatchedGKP on the card."""
    from quantum_computations_tpu_torch.ops import herm_eigh_small as hs, linalg
    from quantum_computations_tpu_torch.pipelines.rb_batched import _dv_state_np, _score_batch
    from quantum_computations_tpu_torch.utils import maybe_trace
    dv_circ, gkp_circ, runner = rb_workload()
    result = {"circuit": [f"{type(g).__name__}{tuple(g.indices)}" for g in dv_circ],
              "layers": gkp_circ.depth(), "batch": RB_BATCH, "grid": len(CV_QS),
              "max_bond_dim": 100, "rel_err": 1e-2, "epsilon": CV_EPS}
    with Phase("9b warm-up (keeps the largest fused inputs)"):
        with largest_inputs() as kept, largest_streamed_split() as split_kept:
            rb_run(runner, gkp_circ)
        torch.cuda.synchronize()
    with Phase("9a fused gadgets at production width"):
        result["fused_at_width"] = fused_at_width(kept)
        del kept
    with Phase(f"9b the trajectory engine, batch {RB_BATCH}"):
        runner.counts.clear()
        runner.largest.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hs.herm_eigh_small.launches = 0
        with randomized_passes() as passes:
            t = time.perf_counter()
            _, frames, rho = rb_run(runner, gkp_circ)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        eigh_launches = hs.herm_eigh_small.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts, largest = dict(runner.counts), dict(runner.largest)
        on_kernel = sum(b >= linalg.KERNEL_MIN_BATCH
                        and linalg.KERNEL_MIN_SIDE <= n <= hs.MAX_N for b, n in passes)
        log(f"9b herm_eigh_small launches {eigh_launches} for {len(passes)} randomized "
            f"split passes of (trajectories, Gram side) {sorted(set(passes))}, {on_kernel} "
            f"of them on the kernel")
        if eigh_launches != 16 * on_kernel or not on_kernel:
            raise AssertionError(f"9b: {eigh_launches} herm_eigh_small launches, not 16 x "
                                 f"{on_kernel} randomized passes")
        syncs = count_syncs(lambda: rb_run(runner, gkp_circ))
        with maybe_trace(RB_TRACE_DIR):
            rb_run(runner, gkp_circ)
        trace = trace_summary(RB_TRACE_DIR, prefix="op:")
        rows, dropped = _score_batch(rho.real, rho.imag, _dv_state_np(dv_circ, 2), 10.0, RB_DEPTH)
        traces = np.trace(rho, axis1=1, axis2=2).real
        fids = [r["fidelity"] for r in rows]
        mean, se = float(np.mean(fids)), float(np.std(fids) / np.sqrt(len(fids)))
        result.update({
            "seconds_per_batch": seconds, "seconds_per_trajectory": seconds / RB_BATCH,
            "trajectories_per_second": RB_BATCH / seconds,
            "host_syncs_per_trajectory": syncs / RB_BATCH, "host_syncs_per_batch": syncs,
            "max_memory_allocated_gib": peak,
            "device_busy_share": trace["device_busy_share"],
            "traced_window_ms": trace["window_ms"], "per_op": trace["per_class"],
            "counts": counts, "largest": largest,
            "herm_eigh_small_launches": eigh_launches, "randomized_passes": passes,
            "trace_range": [float(traces.min()), float(traces.max())],
            "dropped": dropped, "mean_fidelity": mean, "fidelity_se": se,
            "tpu_reference_cell": RB_TPU_CELL})
        log(f"9b {RB_BATCH} trajectories of {result['circuit']} ({result['layers']} "
            f"layers): {seconds:.3f} s per batch, {seconds / RB_BATCH:.4f} s per "
            f"trajectory, {RB_BATCH / seconds:.4f} trajectories/s; host syncs "
            f"{syncs} ({syncs / RB_BATCH:.2f} per trajectory); peak "
            f"{peak:.3f} GiB; device busy {trace['device_busy_share']:.4f} of "
            f"{trace['window_ms']:.1f} ms traced; counts {counts}; largest "
            f"(a, b) {largest}")
        log(f"9b per op span (host ms / device ms): " + "; ".join(
            f"{k} x{v['calls']} {v['host_ms']:.1f} / {v['device_ms']:.1f}"
            for k, v in sorted(trace["per_class"].items(), key=lambda kv: -kv[1]["host_ms"])))
        log(f"9b raw traces in [{traces.min():.6f}, {traces.max():.6f}], dropped "
            f"{dropped}; mean fidelity to the DV state {mean:.4f} (SE {se:.4f}, "
            f"n = {len(fids)}); for scale, {RB_TPU_CELL}")
        if dropped or not np.all(np.isfinite(traces)) or not np.all(traces > 0):
            raise AssertionError(f"9b: traces {traces}")
        if not mean > RB_FID_MIN:
            raise AssertionError(f"9b: mean fidelity {mean} <= {RB_FID_MIN}")
        if counts.get("fused_single", 0) < 1 or not any(k.startswith("fused_pair") for k in counts):
            raise AssertionError(f"9b ran no fused gadget: {counts}")
    with Phase("9c complex64 vs complex128, one trajectory"):
        result["c64_vs_c128"] = trajectory_c64_vs_c128(gkp_circ)
    if "args" in split_kept:
        with Phase("9d the largest streamed split by both BS routes"):
            result["streamed_routes"] = streamed_routes(split_kept["args"])
    return result


# -- the Grover path, the whole-circuit engine and the small pipelines ------
# The first paper's headline workload: pipelines/grover_batched's defaults
# (tagged [0, 4], 12.5 dB, d = 1000 on [-20, 20], chi = 100, rel_err 1e-2,
# BatchedGKP's production settings, seed 42), cut to one batch of two
# trajectories (the pipeline runs 20 in batches of 10).
GROVER_TAGGED = [0, 4]
GROVER_DB = 12.5
GROVER_BATCH = 2
GROVER_SUCCESS_MIN = 0.5   # ideal 1.0; a uniform guess over 8 outcomes 0.25
GROVER_TPU_CELL = ("benchmarks/gkp_grover_tpu_summary.json, gkp_grover_04.dat, "
                   "tagged [0, 4] at 12.5 dB: TPU engine 0.9571 (SE 0.0159, n = 60), "
                   "reference 0.9537 (SE 0.0141, n = 40)")
GROVER_C_POINTS, GROVER_C_CAP = 300, 25  # 10c: benchmarks/grover_fused_ab_cpu.json's size
# complex64 vs complex128 limits of one replayed trajectory: 1 - fidelity,
# max |rho diff|, max rel prob diff. 10c (Grover at d = 300, chi = 25): on
# an H100 the sound readings were 1.6e-12, 6.0e-7, 3.1e-6, tables_f32's
# 2.5e-11, 2.3e-6, 5.1e-6 and env_c64's 8.0e-13, 9.5e-4, 3.1e-2; the
# fidelity separates tables_f32 (limit near the geometric mean), the other
# two are ~20x the sound reading. 10d (grover_compiled's program with the
# exact SVD, seeds 2-4): sound 5.7e-11 to 1.2e-10, 3.1e-6 to 6.1e-6,
# 1.1e-5 to 1.6e-5; the complex64-Gram control 5.0e-9 to 1.9e-7, 2.2e-5 to
# 2.8e-4, 1.1e-4 to 2.1e-4; the same rule (PERF.md §6)
GROVER_LIMITS = (6e-12, 1.2e-5, 6e-5)
COMPILED_LIMITS = {"grover_compiled": (8e-10, 1.2e-4, 3.2e-4)}
CLIFF_TOL = 1e-9           # complex128 on the card vs the JAX package's x64 rows
# 10d: CompiledGKP at its pipelines' own sizes (pipelines/rb_compiled.py,
# pipelines/grover_compiled.py defaults, one circuit / one dB)
COMPILED_RB = {"db": 5.83, "depth": 8, "trajectories": 16, "grid_points": 512,
               "max_bond_dim": 16}
COMPILED_GROVER = {"db": 10.0, "trajectories": 8, "grid_points": 512, "max_bond_dim": 8,
                   "tagged": "2,7"}
EAGER_POINTS = 1000        # 10e: the eager pipelines' grid (d = 1000 on [-20, 20])
SPLIT_CHECK_MAX_SIDE = 24000  # 10b: the largest Gram side formed for the criteria
GROVER_TRACE_DIR = os.path.join("profile_traces", "grover")  # ignored by git


def db_to_eps(db: float) -> float:
    return float(2 * np.arctanh(10 ** (-db / 10) / 2))


def grover_circuit(tagged=GROVER_TAGGED):
    """(transpiled circuit, (N, 2, 2) coefficients of |000>) of the CZ-only
    Grover circuit."""
    from quantum_computations_tpu_torch.gkp import MBGKPCircuit
    from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
    from quantum_computations_tpu_torch.pipelines.grover import grover
    circuit, init = grover(tagged)
    gkp_circ = MBGKPCircuit.transpile(circuit)
    gkp_circ.fill()
    return gkp_circ, logical_coeffs(init)


def count_syncs_by_source(fn) -> dict:
    """Host syncs of ``fn()`` (torch's sync debug mode), split into those
    raised inside ``torch.linalg.eigh`` (cuSOLVER's info check: the
    library's) and all others, with the port's source line of each other
    one; also the eigh calls."""
    import traceback
    counts = {"library": 0, "other": 0, "eigh_calls": 0, "other_sites": []}
    inside, running = [False], [False]
    real_eigh = torch.linalg.eigh

    def eigh(*args, **kw):
        counts["eigh_calls"] += 1
        inside[0] = True
        try:
            return real_eigh(*args, **kw)
        finally:
            inside[0] = False

    def show(message, *args, **kw):
        if "synchroniz" not in str(message) or not running[0]:
            return
        counts["library" if inside[0] else "other"] += 1
        if not inside[0]:
            counts["other_sites"].append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in traceback.extract_stack()[-8:-1][::-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings(), patched(torch.linalg, "eigh", eigh):
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True
        try:
            fn()
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return counts


def grover_batched_run() -> tuple[dict, dict, dict]:
    """10a: pipelines/grover_batched.main at its defaults, one batch of
    GROVER_BATCH trajectories; then the same batch under sync counting and
    under the profiler. Returns (result, the engine, the largest streamed
    split's inputs)."""
    from quantum_computations_tpu_torch.pipelines import grover_batched as gb
    from quantum_computations_tpu_torch.pipelines.grover import success_probability
    from quantum_computations_tpu_torch.utils import maybe_trace
    config = gb.GroverBatchedConfig(
        trajectories=GROVER_BATCH, batch=GROVER_BATCH, overwrite=True,
        data_file=os.path.join(GROVER_TRACE_DIR, "gkp_grover_batched.dat"))
    if [int(x) for x in config.tagged.split(",")] != GROVER_TAGGED or \
            float(config.dbs) != GROVER_DB:
        raise AssertionError(f"GroverBatchedConfig moved: {config}")
    runners, real_cls = [], gb.BatchedGKP

    def engine(*args, **kw):
        runners.append(real_cls(*args, **kw))
        return runners[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with patched(gb, "BatchedGKP", engine), largest_streamed_split() as split_kept:
        data = gb.main(config)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(config.data_file + ".meta.json") as fh:
        meta = json.load(fh)
    runner = runners[0]
    counts, largest = dict(runner.counts), dict(runner.largest)
    rhos = [np.asarray(r["rho_real"]) + 1j * np.asarray(r["rho_imag"]) for r in data]
    success = [success_probability(rho, GROVER_TAGGED) for rho in rhos]
    traces = [float(np.trace(rho).real) for rho in rhos]
    gkp_circ, coeffs = grover_circuit()

    def batch():
        return rb_run(runner, gkp_circ, batch=GROVER_BATCH, seed=config.rng_seed,
                      coeffs=coeffs)

    syncs = count_syncs(batch)
    with maybe_trace(GROVER_TRACE_DIR):
        batch()
    trace = trace_summary(GROVER_TRACE_DIR, prefix="op:")
    result = {
        "config": dataclasses.asdict(config), "layers": gkp_circ.depth(),
        "seconds_per_batch": seconds, "seconds_per_trajectory": seconds / GROVER_BATCH,
        "meta": meta, "host_syncs_per_batch": syncs,
        "host_syncs_per_trajectory": syncs / GROVER_BATCH,
        "max_memory_allocated_gib": peak,
        "device_busy_share": trace["device_busy_share"],
        "traced_window_ms": trace["window_ms"], "per_op": trace["per_class"],
        "counts": counts, "largest": largest, "success": success, "traces": traces,
        "mean_success": float(np.mean(success)), "tpu_reference_cell": GROVER_TPU_CELL}
    log(f"10a Grover {GROVER_TAGGED} at {GROVER_DB} dB, d = {config.grid_points}, chi = "
        f"{config.max_bond_dim}, {gkp_circ.depth()} layers: {seconds:.3f} s per batch "
        f"of {GROVER_BATCH}, {seconds / GROVER_BATCH:.3f} s per trajectory; host syncs "
        f"{syncs} ({syncs / GROVER_BATCH:.1f} per trajectory); peak {peak:.3f} GiB; "
        f"device busy {trace['device_busy_share']:.4f} of {trace['window_ms']:.1f} ms "
        f"traced; counts {counts}; largest (a, b) {largest}")
    log(f"10a per op span (host ms / device ms): " + "; ".join(
        f"{k} x{v['calls']} {v['host_ms']:.1f} / {v['device_ms']:.1f}"
        for k, v in sorted(trace["per_class"].items(), key=lambda kv: -kv[1]["host_ms"])))
    log(f"10a success per trajectory {success}, raw traces {traces}; for scale, "
        f"{GROVER_TPU_CELL}")
    if not all(np.isfinite(traces)) or not min(traces) > 0 or meta[0]["dropped"]:
        raise AssertionError(f"10a: traces {traces}, meta {meta}")
    if not result["mean_success"] > GROVER_SUCCESS_MIN:
        raise AssertionError(f"10a: mean success {success} <= {GROVER_SUCCESS_MIN}")
    if counts.get("fused_single", 0) < 1 or not any(k.startswith("fused_pair") for k in counts):
        raise AssertionError(f"10a ran no fused gadget: {counts}")
    return result, runner, split_kept


def split_criteria(t1, t2, angle) -> dict:
    """10b: one trajectory's streamed split by each BS route against the
    materialised split (the JAX test's criteria, as 8b): reconstruction
    error / dropped singular mass and the kept s^2, from the float64 Gram's
    eigenvalues on the smaller side."""
    from quantum_computations_tpu_torch.ops import interp, linalg, streamed
    a, d, b = t1.shape[0], t1.shape[1], t2.shape[-1]
    qs = torch.as_tensor(CV_QS, dtype=torch.float64, device="cuda")
    warp = ("rot", angle)
    A = interp.affine_warp(qs, torch.tensordot(t1, t2, dims=1), warp).reshape(a * d, d * b)
    G = (A.mH @ A if a >= b else A @ A.mH).to(torch.complex128)
    s64 = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(G), min=0)).flip(0).cpu().numpy()
    del G
    cap = min(100, a * d, d * b)
    q = streamed.effective_power_iters(7 if cap + 10 < 0.1 * min(a * d, d * b) else 4)
    out = {"pair": [a, b], "elements": a * d * d * b,
           "materialised_rank": int(linalg.truncation_rank_mask(
               torch.from_numpy(s64.copy()), 100, 0.0, 1e-2)[0])}
    for decomp in ("rot", "cz"):
        with bs_decomp(decomp):
            m1, m2, rank = streamed.streamed_pair_svd(
                t1, t2, qs, warp, max_bond_dim=100, abs_err=0.0, rel_err=1e-2,
                generator=torch.Generator().manual_seed(3), power_iters=q)
        M1, M2 = m1.reshape(a * d, -1), m2.reshape(-1, d * b)
        err = float(torch.linalg.vector_norm((M1 @ M2 - A).to(torch.complex128)))
        dropped = float(s64[rank:].sum())
        # a kept column of m1 = U sqrt(s) has squared norm s
        kept = np.sort(torch.linalg.vector_norm(M1, dim=0).double().cpu().numpy())[::-1][:rank] ** 2
        out[decomp] = {"rank": rank, "reconstruction_err": err, "dropped_mass": dropped,
                       "err_over_dropped": err / dropped if dropped > 0 else None,
                       "kept_s2_max_rel_diff": float(np.max(np.abs(kept - s64[:rank])
                                                            / s64[:rank]))}
        del m1, m2, M1, M2
    del A
    return out


def grover_split_routes(kept) -> dict:
    """10b: the Grover run's largest streamed split by both BS routes: the
    batch's time and kept ranks (9d's ``streamed_routes``), then the first
    trajectory's split against the materialised one."""
    t1, t2, angle = kept
    out = streamed_routes((t1, t2, angle))
    side = min(t1.shape[1], t2.shape[-1]) * t1.shape[2]
    if side > SPLIT_CHECK_MAX_SIDE:
        log(f"10b criteria skipped: the Gram side {side} > {SPLIT_CHECK_MAX_SIDE}")
        out["criteria"] = None
        return out
    out["criteria"] = split_criteria(t1[0], t2[0], angle)
    log(f"10b criteria (error / dropped, kept s^2) on the first trajectory: "
        f"{out['criteria']}")
    for decomp in ("rot", "cz"):
        c = out["criteria"][decomp]
        out["criteria"][decomp]["meets_error"] = bool(
            c["reconstruction_err"] <= 1.5 * c["dropped_mass"] + 1e-6)
        out["criteria"][decomp]["meets_kept_s2"] = bool(c["kept_s2_max_rel_diff"] <= 1e-2)
    return out


def grover_engine_c64_vs_c128() -> dict:
    """10c: one Grover trajectory at d = 300, chi = 25 (12.5 dB) through
    BatchedGKP, complex64 and two controls against complex128, replayed."""
    qs = np.linspace(-20, 20, GROVER_C_POINTS)
    gkp_circ, coeffs = grover_circuit()
    return c64_vs_c128_replayed(
        lambda: rb_run(rb_engine(qs, db_to_eps(GROVER_DB), GROVER_C_CAP), gkp_circ,
                       batch=1, seed=7, coeffs=coeffs),
        qs, GROVER_LIMITS, "10c")


def compiled_init(prog, coeffs, batch: int):
    from quantum_computations_tpu_torch.config import complex_dtype
    from quantum_computations_tpu_torch.gkp.compiled import product_tensors
    return product_tensors(prog._gkp_basis(), np.asarray(coeffs, np.float32), prog.qs,
                           batch, complex_dtype(prog.device))


def compiled_syncs(prog, coeffs, batch: int) -> dict:
    """Host syncs by source of one CompiledGKP trajectory program (no
    readout) over ``batch`` trajectories."""
    init = compiled_init(prog, coeffs, batch)
    return count_syncs_by_source(lambda: prog.trajectory(init, 1))


def compiled_run(prog, coeffs, batch: int, seed: int):
    """One CompiledGKP batch: (tensors, frames, rho complex128 numpy)."""
    from quantum_computations_tpu_torch.gkp.compiled import corrected_density
    tensors, frames = prog.trajectory(compiled_init(prog, coeffs, batch), seed)
    re, im = corrected_density(tensors, frames, prog.qs)
    return tensors, frames.cpu().numpy(), re.double().cpu().numpy() + 1j * im.double().cpu().numpy()


def compiled_c64_vs_c128(prog, coeffs, name: str) -> dict:
    """10d: one trajectory of a CompiledGKP program, complex64 and controls
    against complex128 with the draws and sketches replayed.

    At these static caps many splits truncate inside a flat or degenerate
    spectrum (s_8/s_1 ~ 0.8 on Grover's at grid 512, cap 8; exact pairs
    of equal s), where the kept directions follow the working precision's
    rounding. The pipeline's own program (the randomized SVD, whose range
    finder does not converge on such spectra) is therefore read, not held;
    rb_compiled's circuit truncates inside a near-degenerate cluster with
    the exact SVD too (1 - F 2e-4 to 9e-4 on an H100). grover_compiled's
    with the exact SVD is well posed: it is held to COMPILED_LIMITS, which
    the complex64-Gram SVD control must break (tables_f32 does not move it
    beyond complex64's own rounding)."""
    from quantum_computations_tpu_torch.gkp.compiled import CompiledGKP
    out = {"c64_vs_c128_randomized": c64_vs_c128_replayed(
        lambda: compiled_run(prog, coeffs, 1, 2), prog.qs, None,
        f"10d {name} (randomized SVD, no limit)", controls=("tables_f32",))}
    if name in COMPILED_LIMITS:
        exact = CompiledGKP(prog.circuit, prog.qs, prog.epsilon,
                            dataclasses.replace(prog.opts, svd_method="full"), device="cuda")
        out["c64_vs_c128_exact_svd"] = c64_vs_c128_replayed(
            lambda: compiled_run(exact, coeffs, 1, 2), prog.qs, COMPILED_LIMITS[name],
            f"10d {name} (exact SVD)", controls=("tables_f32", "gram_c64"),
            must_catch="gram_c64")
    return out


def compiled_path() -> dict:
    """10d: CompiledGKP at its pipelines' sizes on the card:
    rb_compiled.sample_depth_compiled (one depth-8 circuit x 16
    trajectories, 5.83 dB, grid 512, chi 16) and grover_compiled.main (one
    dB, 10.0, 8 trajectories, grid 512, chi 8, tagged 2,7). Each: seconds
    per trajectory, peak memory, the trajectory program's host syncs by
    source (which must be cuSOLVER's eigh alone), and one trajectory in
    complex64 against complex128, replayed (:func:`compiled_c64_vs_c128`)."""
    from quantum_computations_tpu_torch.config import SVDOptions
    from quantum_computations_tpu_torch.dv import State
    from quantum_computations_tpu_torch.gkp.compiled import CompiledGKP, logical_coeffs
    from quantum_computations_tpu_torch.pipelines import grover_compiled as gc
    from quantum_computations_tpu_torch.pipelines import rb_compiled as rbc
    from quantum_computations_tpu_torch.pipelines.rb import random_circ
    out = {}
    c = COMPILED_RB
    qs = np.linspace(-20, 20, c["grid_points"])
    n = c["trajectories"]

    # rb_compiled: the first circuit sample_depth_compiled draws with seed 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = rbc.sample_depth_compiled(c["db"], c["depth"], 1, n, rng_seed=0,
                                     grid_points=c["grid_points"],
                                     max_bond_dim=c["max_bond_dim"], device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, gkp_circ = random_circ(2, c["depth"], np.random.default_rng(0))
    prog = CompiledGKP(gkp_circ, qs, db_to_eps(c["db"]),
                       SVDOptions(max_bond_dim=c["max_bond_dim"], rel_err=1e-2), device="cuda")
    coeffs = logical_coeffs([State.ZERO] * 2)
    syncs = compiled_syncs(prog, coeffs, n)
    fids = [r["fidelity"] for r in rows]
    purs = [r["purity"] for r in rows]
    out["rb_compiled"] = {
        "layers": gkp_circ.depth(), "trajectories": len(rows), "seconds": seconds,
        "seconds_per_trajectory": seconds / len(rows), "max_memory_allocated_gib": peak,
        "syncs_per_batch": syncs, "syncs_per_trajectory": {
            k: syncs[k] / n for k in ("library", "other", "eigh_calls")},
        "fidelities": fids, "purities": purs, "mean_fidelity": float(np.mean(fids)),
        **compiled_c64_vs_c128(prog, coeffs, "rb_compiled")}
    log(f"10d rb_compiled {out['rb_compiled']['layers']} layers, {n} trajectories: "
        f"{seconds:.3f} s ({seconds / n:.4f} s per trajectory), peak {peak:.3f} GiB, "
        f"trajectory syncs by source {syncs}; fidelities {fids}; purities {purs}")
    bad = [v for v in fids + purs if not (np.isfinite(v) and 0 < v <= 1 + 1e-3)]
    if bad or syncs["other"]:
        raise AssertionError(f"10d rb_compiled: out of range {bad}, syncs {syncs}")

    c = COMPILED_GROVER
    n = c["trajectories"]
    config = gc.GroverCompiledConfig(
        dbs=str(c["db"]), traj_per_db=n, grid_points=c["grid_points"],
        max_bond_dim=c["max_bond_dim"], tagged=c["tagged"], overwrite=True,
        data_file=os.path.join(GROVER_TRACE_DIR, "gkp_grover_compiled.dat"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    data = gc.main(config)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    tagged = [int(x) for x in config.tagged.split(",")]
    gkp_circ, coeffs = grover_circuit(tagged)
    prog = CompiledGKP(gkp_circ, np.linspace(-config.grid_span, config.grid_span,
                                             config.grid_points),
                       db_to_eps(c["db"]), SVDOptions(max_bond_dim=config.max_bond_dim,
                                                      rel_err=config.rel_err), device="cuda")
    syncs = compiled_syncs(prog, coeffs, n)
    summary = gc.summarize(data, tagged)
    traces = [float(np.trace(np.asarray(r["rho_real"]))) for r in data]
    out["grover_compiled"] = {
        "layers": gkp_circ.depth(), "trajectories": len(data), "seconds": seconds,
        "seconds_per_trajectory": seconds / len(data), "max_memory_allocated_gib": peak,
        "syncs_per_batch": syncs, "syncs_per_trajectory": {
            k: syncs[k] / n for k in ("library", "other", "eigh_calls")},
        "mean_success": summary, "traces": traces,
        **compiled_c64_vs_c128(prog, coeffs, "grover_compiled")}
    log(f"10d grover_compiled {tagged}, {gkp_circ.depth()} layers, {n} trajectories: "
        f"{seconds:.3f} s ({seconds / n:.4f} s per trajectory), peak {peak:.3f} GiB, "
        f"trajectory syncs by source {syncs}; mean success {summary}; traces {traces}")
    if not all(np.isfinite(traces)) or not min(traces) > 0 or syncs["other"]:
        raise AssertionError(f"10d grover_compiled: traces {traces}, syncs {syncs}")
    return out


def eager_pipelines() -> dict:
    """10e: the eager pipelines and the small ones at d = 1000 on the
    card: grover.main on test_circuit() (one repeat, 10 dB), rb.sample_depth
    (one sample, depth 2, 10 dB), clifford_fidelity.job on the first 8
    classes at the first two dBs against benchmarks/gkp_cliff_generated.dat,
    and process tomography on three channels (the numpy path and the
    device core)."""
    from quantum_computations_tpu_torch.dv import Simulator as DVSim, qop
    from quantum_computations_tpu_torch.pipelines import clifford_fidelity as cf
    from quantum_computations_tpu_torch.pipelines import grover as gr, rb, tomography as tomo
    out = {}
    circuit, init = gr.test_circuit()
    config = gr.GroverConfig(db_min=10.0, db_max=10.0, db_points=1, db_skip=0, repeats=1,
                             grid_points=EAGER_POINTS, overwrite=True,
                             data_file=os.path.join(GROVER_TRACE_DIR, "gkp_grover.dat"))
    t = time.perf_counter()
    with patched(gr, "grover", lambda tagged: (circuit, init)):
        rows = gr.main(config, progress=False)
    seconds = time.perf_counter() - t
    rho = np.asarray(rows[0]["rho_real"]) + 1j * np.asarray(rows[0]["rho_imag"])
    want = DVSim(circuit, device="cuda").run(init).cpu().to(torch.complex128)
    trace = float(np.trace(rho).real)
    fid = float(qop.fidelity(want, torch.from_numpy(rho / trace)))
    out["grover_main_test_circuit"] = {"seconds": seconds, "trace": trace,
                                       "fidelity_to_dv": fid}
    t = time.perf_counter()
    rows = rb.sample_depth(10.0, 2, 1, 5, grid_points=EAGER_POINTS, device="cuda")
    out["rb_sample_depth"] = {"seconds": time.perf_counter() - t, "rows": rows}
    log(f"10e grover.main on test_circuit(): {out['grover_main_test_circuit']}; "
        f"rb.sample_depth: {out['rb_sample_depth']}")
    if not (np.isfinite(trace) and trace > 0 and fid > 0.5):
        raise AssertionError(f"10e grover.main: {out['grover_main_test_circuit']}")
    r = rows[0]
    if not all(np.isfinite(r[k]) and 0 < r[k] <= 1 + 1e-3 for k in ("fidelity", "purity")):
        raise AssertionError(f"10e rb.sample_depth: {rows}")

    with open(os.path.join("benchmarks", "gkp_cliff_generated.dat")) as fh:
        stored = {(round(e["db"], 6), e["clifford_index"]): e["fidelities"] for e in json.load(fh)}
    qs = np.linspace(-20, 20, 1000)  # CliffordConfig's grid, the file's
    reps, paulis = cf.compute_cliffords(), cf.compute_paulis()
    dbs = np.linspace(5.0, 15.0, 13)[:2]
    diffs = {"c128": 0.0, "c64": 0.0}
    t = time.perf_counter()
    for db in dbs:
        for idx in range(8):
            want = np.asarray(stored[(round(float(db), 6), idx)])
            for label, dtype in (("c128", torch.complex128), ("c64", torch.complex64)):
                got = cf.job(qs, db, reps[idx], idx, paulis, device="cuda", dtype=dtype)
                diffs[label] = max(diffs[label],
                                   float(np.abs(np.asarray(got["fidelities"]) - want).max()))
    out["clifford_job"] = {"classes": 8, "dbs": dbs.tolist(), "max_abs_diff": diffs,
                           "seconds": time.perf_counter() - t, "tolerance_c128": CLIFF_TOL}
    log(f"10e clifford_fidelity.job, 8 classes x 2 dBs at d = 1000 against "
        f"benchmarks/gkp_cliff_generated.dat: {out['clifford_job']}")
    if not diffs["c128"] <= CLIFF_TOL:
        raise AssertionError(f"10e clifford job off the stored rows: {diffs}")

    p = 0.25
    channels = {"identity": ([np.identity(2)], 1),
                "depolarizing": ([np.sqrt(1 - p) * qop.IDTY]
                                 + [np.sqrt(p / 3) * P for P in qop.PAULIS], 1),
                "cz": ([np.asarray(qop.CZ)], 2)}
    out["tomography"] = {}
    for name, (Ks, N) in channels.items():
        chan = tomo.quantum_channel(Ks, ket_input=True, return_input=True)
        D, kraus = tomo.process_tomography(chan, N, normalised=True, full_output=True)
        inputs, outputs = tomo.eval_process(chan, N, True)
        basis = tomo.pauli_basis(N)
        M = tomo.fit_superoperator(np.stack(inputs), np.stack(outputs), device="cuda")
        Dd, Kd = tomo.kraus_from_chi(tomo.chi_from_superoperator(M, basis, device="cuda"),
                                     basis, device="cuda")
        probe = np.outer(np.arange(1, 2**N + 1), np.arange(1, 2**N + 1)) / 2**N
        apply = lambda w, k: sum(x * a @ probe @ a.conj().T for x, a in zip(w, k))  # noqa: E731
        err = float(np.abs(apply(Dd.cpu().numpy(), Kd.cpu().numpy())
                           - apply(D, kraus)).max())
        kept = int((D > 1e-12).sum())
        out["tomography"][name] = {"kraus_rank": kept, "device_vs_numpy": err}
        if not err < 1e-10 or kept != (4 if name == "depolarizing" else 1):
            raise AssertionError(f"10e tomography {name}: {out['tomography'][name]}")
    log(f"10e tomography (device core on the card vs the numpy path): "
        f"{out['tomography']}")
    return out


def grover_path() -> dict:
    """Phase 10: the Grover path, the whole-circuit engine and the small
    pipelines on the card."""
    result = {}
    with Phase(f"10a Grover through pipelines/grover_batched, batch {GROVER_BATCH}"):
        result["grover_batched"], runner, split_kept = grover_batched_run()
    streamed = result["grover_batched"]["counts"].get("bs_streamed", 0)
    if "args" in split_kept:
        with Phase("10b the Grover run's largest streamed split by both BS routes"):
            result["streamed_routes"] = grover_split_routes(split_kept["args"])
    else:
        result["streamed_routes"] = None
        log(f"10b nothing streamed ({streamed} streamed splits); largest pairs "
            f"{runner.largest}")
    del split_kept, runner
    with Phase("10c Grover, one trajectory, complex64 vs complex128"):
        result["c64_vs_c128"] = grover_engine_c64_vs_c128()
    with Phase("10d CompiledGKP at its pipelines' sizes"):
        result["compiled"] = compiled_path()
    with Phase("10e the eager and the small pipelines at d = 1000"):
        result["eager"] = eager_pipelines()
    return result


# -- phase 11: engine threads on CUDA streams, and the second paper ---------
# 11a: the Grover cell of 10a and bench.py's RB settings, each at 1, 2 and 4
# engine threads (one CUDA stream per engine, pipelines/common.run_engines),
# one batch per engine. Each count runs once: s per trajectory, host
# syncs, peak memory and host seconds per engine span summed over the
# threads; at THREAD_TRACED counts the same run is also traced for the
# device-busy share (the union of device intervals over every stream), so
# its time includes the tracer's cost. The trace costs ~30 us of host
# time per device event after the run (~30 s for a 4-engine run, whose
# busy share PR 11's runs recorded), which is why only the 1-engine runs
# are traced. Rows must not depend on the thread count: a threaded Grover
# row equals the serial row of its (rng_seed, rng_lane), and the threaded
# RB rows and the serial rows of the same circuits (the shared generator
# draws them in the same order) pair up both ways, to THREAD_ROW_TOL.
THREAD_COUNTS = (1, 2, 4)
THREAD_TRACED = (1,)
THREAD_ROW_TOL = 1e-6
THREADS_DATA_DIR = os.path.join("profile_traces", "threads")  # ignored by git


def count_sync_total(fn) -> int:
    """Host syncs of ``fn()`` in every thread, as torch's sync debug mode
    reports them; only a count, so it costs the run little (the per-source
    attribution of :func:`count_syncs_by_source` is not thread-safe)."""
    n, running = [0], [False]

    def show(message, *args, **kw):
        if running[0] and "synchroniz" in str(message):
            n[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True
        try:
            fn()
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return n[0]


def measure_threads(fn, traced: bool) -> dict:
    """``fn()`` (which returns its rows, one per trajectory) run once,
    timed, with its host syncs counted and the engines' host spans summed
    over threads (``utils.profiling.recording``); if ``traced``, under a
    CUDA-only ``torch.profiler`` trace (every stream; the profiler
    records no CPU span of threads it was not started in). The busy
    window runs from a one-element fill launched on the idle card just
    before ``fn`` to another launched after it has drained; the busy time
    is the union of all device intervals inside it, read from the
    profiler's events without a trace file."""
    from quantum_computations_tpu_torch.utils import profiling
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            if traced else contextlib.nullcontext())
    with profiling.recording(), prof:
        marker.fill_(1.0)
        t = time.perf_counter()
        syncs = count_sync_total(lambda: out.update(result=fn()))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        marker.fill_(2.0)
        torch.cuda.synchronize()
    spans = profiling.table()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trajectories = len(out["result"])
    result = {"result": out["result"], "seconds": seconds, "trajectories": trajectories,
              "seconds_per_trajectory": seconds / trajectories, "traced": traced,
              "host_syncs": syncs, "host_syncs_per_trajectory": syncs / trajectories,
              "max_memory_allocated_gib": peak,
              "host_s_per_span_summed_over_threads": {
                  k: v["seconds"] for k, v in spans.items() if k.startswith("op:")}}
    if not traced:
        return result
    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s0 = e.start_ns()
            device.append((s0, s0 + e.duration_ns()))
    device.sort()
    if len(device) < 3:
        raise AssertionError(f"the trace holds {len(device)} device events")
    t0, t1 = device[0][0], max(f for _, f in device)
    busy, end = 0, t0
    for s0, f in device:
        s0 = max(s0, end)
        if f > s0:
            busy += f - s0
            end = f
    return {**result, "device_busy_share": busy / (t1 - t0), "traced_window_ms": (t1 - t0) / 1e6,
            "device_busy_ms": busy / 1e6, "device_events": len(device)}


def grover_rows(threads: int, batches: int, rng_seed: int = 42, tag: str = "") -> list:
    """Rows of grover_batched.main at 10a's cell with ``threads`` engines
    and a target of ``batches`` batches of GROVER_BATCH. With a target of
    one batch, every engine reserves its batch before the first one
    finishes, so each runs one (a thread that finishes while the target
    is unmet takes another, as in the JAX package); batch k's seed is
    rng_seed + k GROVER_BATCH at any thread count."""
    from quantum_computations_tpu_torch.pipelines import grover_batched as gb
    config = gb.GroverBatchedConfig(
        trajectories=batches * GROVER_BATCH, batch=GROVER_BATCH, threads=threads,
        rng_seed=rng_seed, overwrite=True,
        data_file=os.path.join(THREADS_DATA_DIR, f"grover_{threads}{tag}.dat"))
    os.makedirs(THREADS_DATA_DIR, exist_ok=True)
    data = gb.main(config)
    with open(config.data_file + ".meta.json") as fh:
        meta = json.load(fh)
    if meta[0]["engine"]["threads"] != threads or meta[0]["dropped"]:
        raise AssertionError(f"11a Grover meta: {meta}")
    return data


def rb_rows(threads: int, batches: int) -> list:
    """bench.py's RB settings through rb_batched.sample_depth_batched with
    ``threads`` engines and a target of ``batches`` batches of RB_BATCH
    (as in :func:`grover_rows`): the circuits come from one generator
    seeded with RB_CIRCUIT_SEED, so the k-th circuit drawn is the same at
    any thread count."""
    from quantum_computations_tpu_torch.pipelines.rb_batched import sample_depth_batched
    runners = [rb_engine() for _ in range(threads)]
    stats = {}
    rows = sample_depth_batched(runners[0], 10.0, RB_DEPTH, batches * RB_BATCH, RB_BATCH,
                                np.random.default_rng(RB_CIRCUIT_SEED), stats,
                                runners=runners)
    if stats["dropped"]:
        raise AssertionError(f"11a RB dropped trajectories: {stats}")
    return rows


def rows_apart(rows, others, keys=("fidelity", "purity", "trace")) -> float:
    """The largest distance from a row of ``rows`` to its nearest row of
    ``others`` (the largest difference over ``keys``)."""
    return max(min(max(abs(r[k] - o[k]) for k in keys) for o in others) for r in rows)


def threads_path() -> dict:
    """Phase 11a."""
    from quantum_computations_tpu_torch.pipelines.grover import success_probability
    out = {"grover": {}, "rb": {}}
    for threads in THREAD_COUNTS:
        traced = threads in THREAD_TRACED
        with Phase(f"11a Grover with {threads} engine thread(s)"):
            m = measure_threads(lambda: grover_rows(threads, 1), traced)
            rows = m.pop("result")
            success = [success_probability(np.asarray(r["rho_real"]) + 1j * np.asarray(
                r["rho_imag"]), GROVER_TAGGED) for r in rows]
            traces = [float(np.trace(np.asarray(r["rho_real"]))) for r in rows]
            m.update(rows=rows, success=success, traces=traces,
                     mean_success=float(np.mean(success)))
            out["grover"][threads] = m
        with Phase(f"11a RB with {threads} engine thread(s)"):
            m = measure_threads(lambda: rb_rows(threads, 1), traced)
            rows = m.pop("result")
            m.update(rows=rows, traces=[r["trace"] for r in rows],
                     mean_fidelity=float(np.mean([r["fidelity"] for r in rows])))
            out["rb"][threads] = m
    with Phase("11a no race: threaded rows against serial rows"):
        # serial runs of the batches that the threaded runs drew
        serial = {(r["rng_seed"], r["rng_lane"]): r for r in out["grover"][1]["rows"]}
        for threads in THREAD_COUNTS[1:]:
            for seed in sorted({r["rng_seed"] for r in out["grover"][threads]["rows"]}):
                if (seed, 0) not in serial:
                    for r in grover_rows(1, 1, rng_seed=seed, tag=f"_ref{seed}"):
                        serial[(r["rng_seed"], r["rng_lane"])] = r
        grover_err = 0.0
        for threads in THREAD_COUNTS[1:]:
            for r in out["grover"][threads]["rows"]:
                s = serial[(r["rng_seed"], r["rng_lane"])]
                grover_err = max(grover_err, *(
                    float(np.abs(np.asarray(r[k]) - np.asarray(s[k])).max())
                    for k in ("rho_real", "rho_imag")))
        rb_serial = rb_rows(1, max(len(out["rb"][t]["rows"]) for t in THREAD_COUNTS) // RB_BATCH)
        rb_err = 0.0
        for threads in THREAD_COUNTS[1:]:
            rows = out["rb"][threads]["rows"]
            same = rb_serial[:len(rows)]  # the serial rows of the same circuits
            rb_err = max(rb_err, rows_apart(rows, same), rows_apart(same, rows))
        out["no_race"] = {"grover_max_abs_rho_diff": grover_err,
                          "rb_max_row_diff": rb_err, "tolerance": THREAD_ROW_TOL,
                          "serial_grover_batches": len(serial) // GROVER_BATCH,
                          "serial_rb_batches": len(rb_serial) // RB_BATCH}
        log(f"11a no race: Grover max |d rho| {grover_err:.3e} over "
            f"{len(serial) // GROVER_BATCH} serial batches, RB max row diff "
            f"{rb_err:.3e} both ways over {len(rb_serial) // RB_BATCH} serial batches "
            f"(tolerance {THREAD_ROW_TOL})")
    for name in ("grover", "rb"):
        for threads, m in out[name].items():
            score = m.get("mean_success", m.get("mean_fidelity"))
            busy = (f"device busy {m['device_busy_share']:.4f} of {m['traced_window_ms']:.1f} "
                    f"ms traced ({m['device_events']} device events)" if m["traced"]
                    else "not traced")
            log(f"11a {name} x{threads}: {m['seconds_per_trajectory']:.4f} s per trajectory "
                f"({m['trajectories']} in {m['seconds']:.3f} s); host syncs per "
                f"trajectory {m['host_syncs_per_trajectory']:.2f}; peak "
                f"{m['max_memory_allocated_gib']:.3f} GiB; {busy}; mean score {score:.4f}")
            log(f"11a {name} x{threads} host s per op span, summed over threads: "
                + "; ".join(f"{k} {v:.3f}" for k, v in sorted(
                    m["host_s_per_span_summed_over_threads"].items(), key=lambda kv: -kv[1])))
            traces = np.asarray(m["traces"])
            if not (np.all(np.isfinite(traces)) and np.all(traces > 0)):
                raise AssertionError(f"11a {name} x{threads}: traces {traces}")
            floor = GROVER_SUCCESS_MIN if name == "grover" else RB_FID_MIN
            if not score > floor:
                raise AssertionError(f"11a {name} x{threads}: mean score {score} <= {floor}")
            del m["rows"]
    if not (out["no_race"]["grover_max_abs_rho_diff"] <= THREAD_ROW_TOL
            and out["no_race"]["rb_max_row_diff"] <= THREAD_ROW_TOL):
        raise AssertionError(f"11a threaded rows differ from the serial rows: "
                             f"{out['no_race']}")
    return out


# 11b: the second paper's suite (pipelines/gkp_ec_validation) at its default
# grids, in the port's default complex64 and again in complex128, and the
# five pipelines/cv_circuits lists through cv.Simulator at d = 1000, cap
# 100, 10 dB with seeded outcomes. complex128 is held to the thresholds of
# tests/test_gkp_ec_validation.py; complex64 against complex128 within
# EC_C64_LIMITS: absolute differences of each output, set before the first
# card run at ~20x a CPU complex64 run's readings (the fitted widths
# 1.7e-8, the Wigner difference 6.4e-8 and overlap 1.9e-8 of Knill-Steane,
# logical fidelities up to 1.3e-6; PERF.md §6).
EC_EXPERIMENTS = ("steane_ec_width_test", "knill_steane_equivalence_check",
                  "imperfect_p_gate_experiment", "imperfect_cx_gate_experiment",
                  "bell_state_comparison")
EC_C64_LIMITS = {"numeric_q": 4e-7, "numeric_p": 4e-7, "max_wigner_diff": 2e-6,
                 "rel_wigner_diff": 1e-5, "overlap": 5e-7, "fidelity": 3e-5}
EC_CIRCUITS = {  # name: (initial state of mode 0 or None, seed)
    "qunaught_error_correction": ("GKP_H", 7), "quadrature_correction": ("GKP_ZERO", 2),
    "steane_error_correction": ("GKP_PLUS", 4), "bell_standard": (None, 3),
    "bell_qunaught": (None, 5)}


def ec_thresholds(res: dict) -> dict:
    """tests/test_gkp_ec_validation.py's pass conditions on one dtype's
    results."""
    w, k = res["steane_ec_width_test"], res["knill_steane_equivalence_check"]
    p, c = res["imperfect_p_gate_experiment"], res["imperfect_cx_gate_experiment"]
    b = res["bell_state_comparison"]
    return {
        "width_q": abs(w["numeric_q"] - w["analytic_q"]) / w["analytic_q"] < 0.05,
        "width_p": abs(w["numeric_p"] - w["analytic_p"]) / w["analytic_p"] < 0.05,
        "knill_wigner": k["rel_wigner_diff"] < 1e-4,
        "knill_overlap": k["overlap"] > 1 - 1e-6,
        "p_gate_dip": p["after_gate"] < p["initial"] - 0.005,
        "p_gate_recovery": p["after_projection"] > p["initial"] - 0.001,
        "cx_gate_dip": c["after_gate"] < c["initial"] - 0.02,
        "cx_gate_recovery": c["after_projection"] > c["initial"] - 0.005,
        "bell_entangles": b["qunaught_bell"] > b["qunaught_before"] + 0.3,
        "bell_qunaught_wins": b["qunaught_bell"] > b["gkp_bell"] + 0.05,
        "bell_cx_loses": b["gkp_bell"] < b["gkp_before"],
    }


def ec_suite() -> dict:
    """11b, the six experiments in both dtypes."""
    from quantum_computations_tpu_torch.pipelines import gkp_ec_validation as val
    out = {"complex64": {}, "complex128": {}, "seconds": {}}
    t = time.perf_counter()
    out["gaussian_product_failed"] = val.gaussian_product_identity_check()
    out["seconds"]["gaussian_product_identity_check"] = time.perf_counter() - t
    for label, ctx in (("complex64", contextlib.nullcontext), ("complex128", x64_dtype)):
        for name in EC_EXPERIMENTS:
            with ctx():
                torch.cuda.synchronize()
                t = time.perf_counter()
                out[label][name] = getattr(val, name)(device="cuda")
                torch.cuda.synchronize()
                out["seconds"][f"{name}:{label}"] = time.perf_counter() - t
    diffs = {}
    for name in EC_EXPERIMENTS:
        for key, want in out["complex128"][name].items():
            limit = EC_C64_LIMITS.get(key, EC_C64_LIMITS["fidelity"])
            diffs[f"{name}:{key}"] = (abs(out["complex64"][name][key] - want), limit)
    out["c64_vs_c128"] = diffs
    out["thresholds"] = {label: ec_thresholds(out[label]) for label in ("complex64", "complex128")}
    log(f"11b gkp_ec_validation at default grids: complex128 {out['complex128']}; "
        f"complex64 {out['complex64']}; Gaussian-product failures "
        f"{out['gaussian_product_failed']}; seconds {out['seconds']}")
    log(f"11b complex64 vs complex128 (|diff|, limit): {diffs}; JAX test thresholds "
        f"{out['thresholds']}")
    bad = {k: v for k, v in diffs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"11b complex64 leaves complex128: {bad}")
    if out["gaussian_product_failed"] or not all(out["thresholds"]["complex128"].values()):
        raise AssertionError(f"11b complex128 misses the JAX thresholds: {out['thresholds']}")
    return out


def ec_circuits() -> dict:
    """11b, the five cv_circuits lists through cv.Simulator; phase 7's S
    and Q lists against cv_circuits'."""
    from quantum_computations_tpu_torch.config import SVDOptions
    from quantum_computations_tpu_torch.cv import MPS, Simulator, State, gates as cg
    from quantum_computations_tpu_torch.dv import qop
    from quantum_computations_tpu_torch.gkp import full_logical_density_mps
    from quantum_computations_tpu_torch.pipelines import cv_circuits as cc

    def fields(gates):
        return [(type(g).__name__, {k: repr(v) for k, v in sorted(vars(g).items())})
                for g in gates]

    same = {"S": fields(cv_circuit("S", cg, State)) == fields(cc.steane_error_correction(CV_EPS)),
            "Q": fields(cv_circuit("Q", cg, State)) == fields(cc.qunaught_error_correction(CV_EPS))}
    if not all(same.values()):
        raise AssertionError(f"11b phase 7's circuits differ from cv_circuits': {same}")
    out = {"phase7_lists_equal": same}
    opts = SVDOptions(max_bond_dim=100, rel_err=1e-2)
    for name, (init, seed) in EC_CIRCUITS.items():
        initial = [getattr(State, init).eval(CV_QS, CV_EPS, device="cuda")] if init else []
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim = Simulator(getattr(cc, name)(CV_EPS), rng_seed=seed, svd_options=opts)
        mps = sim.run(MPS(CV_QS, initial, device="cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        rho = full_logical_density_mps(mps, normalised=True).cpu().to(torch.complex128)
        row = {"seconds": seconds, "modes": len(mps), "outcomes": len(sim.results),
               "norm": float(mps.norm()), "bonds": kept_ranks(mps)}
        if name == "quadrature_correction":  # tests/test_cv_circuits.py's condition
            row["z_weight"] = float(rho[0, 0].real + rho[1, 1].real)
        if name == "bell_qunaught":
            bell = torch.zeros(4, dtype=torch.complex128)
            bell[0] = bell[3] = 2**-0.5
            row["bell_fidelity"] = float(qop.fidelity(bell, rho))
        out[name] = row
        if not (np.isfinite(row["norm"]) and row["norm"] > 0
                and row.get("z_weight", 1.0) > 0.95 and row.get("bell_fidelity", 1.0) > 0.8):
            raise AssertionError(f"11b {name}: {row}")
    log(f"11b cv_circuits through cv.Simulator at d = {len(CV_QS)}, cap 100: {out}")
    return out


def ec_path() -> dict:
    """Phase 11b."""
    result = {}
    with Phase("11b gkp_ec_validation at its default grids, complex64 and complex128"):
        result["validation"] = ec_suite()
    with Phase("11b cv_circuits through cv.Simulator"):
        result["circuits"] = ec_circuits()
    return result


# -- phase 12: the sharded engines on torch.distributed ------------------------
# 12a: ShardMapStateVector(30) on a world of one under NCCL (a FileStore
# rendezvous, so NCCL's all_reduce, gathers and broadcasts run), phase 4's
# chains and a seeded layer of rotations and CZs through run_fused_slab,
# every marginal and SV_AMPS amplitudes held against FastStatevector(30)
# in slab mode (the kernel engine) within limits read from the same
# circuit at N = 26 against the ShardMap engine in complex128; then
# measure and sample. 12b: a world of SV_RANKS ranks on cuda:0 over gloo
# (NCCL refuses two ranks on one card) at N = 28, the mixed circuit (gates
# on rank-bit qubits: lazy swaps), run_fused_slab with its planner, a
# measurement of a rank-bit qubit and samples, for ShardMapStateVector and
# ShardedStateVector, held against a world of one within SV_WORLD_TOL.
# 12c: BatchedGKP.run_circuit(data_sharding=data_mesh()) on bench.py's
# workload at 1, 2 and 4 ranks on the one card, and 10a's Grover cell at 1
# and 4, every row within SHARD_ROW_TOL of the serial run of the seed.
SV_N = 30
SV_N_CALIB = 26
SV_N_WORLD = 28
SV_RANKS = 4
SV_AMPS = 64
SV_LIMIT_HEADROOM = 10.0   # N = 30 limit: this times the N = 26 error to complex128
SV_WORLD_TOL = 1e-5        # 12b: a world of SV_RANKS against a world of one
SV_SAMPLES = 4096
SHARD_WORLDS = (1, 2, 4)
SHARD_GROVER_WORLDS = (1, 4)
SHARD_GROVER_BATCH = 4
SHARD_ROW_TOL = 1e-6


def sv_slab_circuit(n: int) -> list:
    """Phase 4's chains a and b at width n, then a seeded layer of random
    rotations on every qubit and CZ on neighbouring pairs."""
    from quantum_computations_tpu_torch.dv import qop
    H, T = np.asarray(qop.H), np.asarray(qop.T)
    spread = list(dict.fromkeys((3 + 2 * i) % (n - 1) for i in range(14)))
    gates = [(H, (q,)) for q in (spread * 2)[:24]]
    gates += [(H, (q,)) for q in range(n - 7, n)] + [(T, (q,)) for q in range(n - 7, n)]
    rng = np.random.default_rng(1200 + n)
    gates += [(random_unitary(2, rng), (q,)) for q in range(n)]
    gates += [(np.asarray(qop.CZ), (q, q + 1)) for q in range(0, n - 1, 2)]
    return gates


def sv_mixed_circuit(n: int) -> list:
    """tests/test_shardmap_sv.py's mixed circuit at width n: gates on the
    leading (rank-bit) qubits, across and on local qubits."""
    from quantum_computations_tpu_torch.dv import qop
    rng = np.random.default_rng(1300 + n)
    return [(qop.H, (0,)), (random_unitary(4, rng), (0, n - 1)), (qop.CZ, (1, 2)),
            (random_unitary(2, rng), (5,)), (random_unitary(4, rng), (2, 0)),
            (qop.CX, (n - 11, 3)), (random_unitary(4, rng), (1, n - 2)), (qop.H, (2,))]


def sv_sharded_circuit(n: int) -> list:
    """ShardedStateVector's circuit: the mixed circuit, then the seeded
    layer of sv_slab_circuit (rotations on every qubit, CZ on pairs)."""
    return sv_mixed_circuit(n) + sv_slab_circuit(n)[-(n + n // 2):]


def amp_indices(n: int) -> np.ndarray:
    return np.random.default_rng(1400 + n).integers(0, 1 << n, SV_AMPS)


def physical(idx: np.ndarray, n: int, pos) -> np.ndarray:
    """Basis indices with logical bit q moved to physical bit pos[q] (both
    MSB first)."""
    out = np.zeros_like(idx)
    for q in range(n):
        out |= ((idx >> (n - 1 - q)) & 1) << (n - 1 - pos[q])
    return out


def sm_readout(sv, idx) -> tuple[np.ndarray, np.ndarray]:
    """(every qubit's marginal (N, 2), the amplitudes at logical ``idx``)
    of a ShardMapStateVector, on every rank."""
    marg = torch.stack([sv.probabilities(q) for q in range(sv.N)]).double().cpu().numpy()
    phys = physical(idx, sv.N, sv.slot_of)
    own = np.nonzero((phys >> sv.L) == sv.mesh.rank)[0]
    vals = torch.zeros(len(idx), dtype=sv.state.dtype, device=sv.device)
    if len(own):
        loc = torch.from_numpy(phys[own] & ((1 << sv.L) - 1)).to(sv.device)
        vals[torch.from_numpy(own).to(sv.device)] = sv.state[loc]
    return marg, sv.mesh.all_reduce(vals).cpu().numpy().astype(np.complex128)


def ssv_readout(sv, idx) -> tuple[np.ndarray, np.ndarray]:
    """The same of a ShardedStateVector (amplitudes through ``amplitude``)."""
    marg = torch.stack([sv.probabilities(q) for q in range(sv.N)]).double().cpu().numpy()
    amps = [complex(sv.amplitude([(int(i) >> (sv.N - 1 - q)) & 1 for q in range(sv.N)]))
            for i in idx]
    return marg, np.asarray(amps)


def fast_readout(sv, idx) -> tuple[np.ndarray, np.ndarray]:
    marg = torch.stack([sv.probabilities(q) for q in range(sv.N)]).double().cpu().numpy()
    phys = torch.from_numpy(physical(idx, sv.N, sv.axis_of)).cuda()
    return marg, (sv.re[phys].double() + 1j * sv.im[phys].double()).cpu().numpy()


def readout_diff(a, b) -> dict:
    return {"marginal": float(np.abs(a[0] - b[0]).max()),
            "amplitude": float(np.abs(a[1] - b[1]).max())}


def plan_counts(plan) -> dict:
    kinds = [op[0] for op in plan]
    return {k: kinds.count(k) for k in sorted(set(kinds))}


def rank_gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def mesh_barrier(mesh):
    mesh.all_reduce(torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()


def sample_check(bits, marg, q, outcome, label: str):
    """Samples of a state measured on qubit ``q``: that qubit is
    ``outcome`` in every sample, the others' frequencies within 5 standard
    errors of their marginals."""
    if not (bits[:, q] == outcome).all():
        raise AssertionError(f"{label}: a sample left the measured qubit {q}")
    p1 = marg[:, 1]
    se = np.maximum(np.sqrt(p1 * (1 - p1) / len(bits)), 1e-3)
    worst = float(np.max(np.abs(bits.mean(0) - p1) / se))
    if not worst < 5:
        raise AssertionError(f"{label}: sample frequencies {worst:.1f} SE off the marginals")
    return worst


def gloo_cuda_check(mesh) -> dict:
    """all_to_all_single and all_reduce on CUDA tensors over this world's
    backend: raises if the backend refuses them."""
    send = torch.full((4,), complex(mesh.rank, 1), dtype=torch.complex64, device=mesh.device)
    partner = mesh.rank ^ 1
    recv = mesh.exchange(send, partner)
    total = mesh.all_reduce(torch.ones(1, device=mesh.device))
    if recv.real[0].item() != partner or total.item() != mesh.size:
        raise AssertionError(f"collectives on CUDA tensors gave {recv.tolist()}, "
                             f"{total.item()}")
    return {"all_to_all_single": "ok", "all_reduce": "ok",
            "backend": str(torch.distributed.get_backend(mesh.group))}


def sv_world_many(mesh) -> dict:
    """12b on every rank of a world of SV_RANKS on one card."""
    from quantum_computations_tpu_torch.parallel import ShardedStateVector, qubit_mesh
    from quantum_computations_tpu_torch.parallel.shardmap_sv import ShardMapStateVector
    torch.backends.cuda.matmul.allow_tf32 = False
    n = SV_N_WORLD
    out = {"collectives": gloo_cuda_check(mesh)}
    idx = amp_indices(n)
    torch.cuda.reset_peak_memory_stats()
    sv = ShardMapStateVector(n, mesh)
    mesh_barrier(mesh)
    t = time.perf_counter()
    for m, tg in sv_mixed_circuit(n):
        sv.apply(m, tg)
    applied = sv.exchanges
    sv.run_fused_slab(sv_slab_circuit(n))
    mesh_barrier(mesh)
    seconds = time.perf_counter() - t
    pre = sm_readout(sv, idx)
    q = sv.slot_of.index(0)  # the qubit in rank bit 0 after the plan
    outcome = sv.measure(q, rank_gen(21))
    post = sm_readout(sv, idx)
    bits = sv.sample(rank_gen(22), SV_SAMPLES)
    worst = sample_check(bits, post[0], q, outcome, "12b ShardMap")
    # ms per exchange: rank bit 0 with the top local bit, four times
    mesh_barrier(mesh)
    t = time.perf_counter()
    for _ in range(4):
        sv._swap_global_local(0, sv.k)
    mesh_barrier(mesh)
    exchange_ms = (time.perf_counter() - t) / 4 * 1e3
    out["shardmap"] = dict(
        seconds=seconds, apply_exchanges=applied, plan=plan_counts(sv.last_plan),
        a2a=plan_counts(sv.last_plan).get("a2a", 0), slot_of=list(sv.slot_of),
        measured=q, outcome=outcome, pre=pre, post=post, sample_worst_se=worst,
        exchange_ms=exchange_ms, half_block_mib=(1 << (n - sv.k - 1)) * 8 / 2**20)
    del sv
    ssv = ShardedStateVector(n, qubit_mesh(mesh.size.bit_length() - 1, device=mesh.device))
    ssv.run_circuit(sv_sharded_circuit(n))
    pre = ssv_readout(ssv, idx)
    outcome = ssv.measure(0, rank_gen(23))
    out["sharded"] = dict(outcome=outcome, pre=pre, post=ssv_readout(ssv, idx))
    del ssv
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 2**30], device=mesh.device)
    out["peak_gib_per_rank"] = mesh.all_gather(peak).tolist()
    return out


def sv_world_one(mesh, many: dict) -> dict:
    """12a, then 12b's reference, on a world of one."""
    from quantum_computations_tpu_torch.dv import FastStatevector
    from quantum_computations_tpu_torch.parallel import ShardedStateVector, qubit_mesh
    from quantum_computations_tpu_torch.parallel.shardmap_sv import ShardMapStateVector
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"backend": str(torch.distributed.get_backend(mesh.group))}
    # the limits: the same circuit at N = 26 against complex128
    n = SV_N_CALIB
    idx = amp_indices(n)
    gates = sv_slab_circuit(n)
    with x64_dtype():
        ref = sm_readout(ShardMapStateVector(n, mesh).run_fused_slab(gates), idx)
    got = sm_readout(ShardMapStateVector(n, mesh).run_fused_slab(gates), idx)
    fast = fast_readout(FastStatevector(n, device="cuda").run_compiled(gates), idx)
    calib = {"shardmap_c64": readout_diff(got, ref), "fast_sv": readout_diff(fast, ref)}
    limits = {k: SV_LIMIT_HEADROOM * max(v[k] for v in calib.values())
              for k in ("marginal", "amplitude")}
    out["calibration"] = dict(n=n, errors_to_complex128=calib, limits=limits)
    torch.cuda.empty_cache()
    # 12a at full width
    n = SV_N
    idx = amp_indices(n)
    gates = sv_slab_circuit(n)
    torch.cuda.reset_peak_memory_stats()
    sv = ShardMapStateVector(n, mesh)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sv.run_fused_slab(gates)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = sm_readout(sv, idx)
    marg = got[0][:, 1]
    q = int(np.argmin(np.abs(marg - 0.5)))  # the most uncertain qubit
    outcome = sv.measure(q, rank_gen(12))
    post = sm_readout(sv, idx)
    if abs(post[0][q, outcome] - 1.0) > 1e-5 or abs(float(sv.norm()) - 1.0) > 1e-4:
        raise AssertionError(f"12a: measuring qubit {q} left {post[0][q]}, norm "
                             f"{float(sv.norm())}")
    t = time.perf_counter()
    bits = sv.sample(rank_gen(13), SV_SAMPLES)
    sample_s = time.perf_counter() - t
    worst = sample_check(bits, post[0], q, outcome, "12a")
    out["main"] = dict(n=n, seconds=seconds, peak_gib=peak, plan=plan_counts(sv.last_plan),
                       gates=len(gates), measured=q, outcome=outcome,
                       p_outcome=float(got[0][q, outcome]), sample_seconds=sample_s,
                       samples=SV_SAMPLES, sample_worst_se=worst,
                       state_gib=sv.state.numel() * sv.state.element_size() / 2**30)
    del sv
    torch.cuda.empty_cache()
    fast = FastStatevector(n, device="cuda").run_compiled(gates)
    out["main"]["against_fast_sv"] = readout_diff(got, fast_readout(fast, idx))
    del fast
    torch.cuda.empty_cache()
    # 12b's reference: the same steps on a world of one, its outcomes forced
    n = SV_N_WORLD
    idx = amp_indices(n)
    ref = {}
    sv = ShardMapStateVector(n, mesh)
    for m, tg in sv_mixed_circuit(n):
        sv.apply(m, tg)
    sv.run_fused_slab(sv_slab_circuit(n))
    pre = sm_readout(sv, idx)
    sv.measure(many["shardmap"]["measured"], result=many["shardmap"]["outcome"])
    ref["shardmap"] = dict(pre=pre, post=sm_readout(sv, idx), plan=plan_counts(sv.last_plan))
    del sv
    ssv = ShardedStateVector(n, qubit_mesh(0, device=mesh.device))
    ssv.run_circuit(sv_sharded_circuit(n))
    pre = ssv_readout(ssv, idx)
    ssv.measure(0, result=many["sharded"]["outcome"])
    ref["sharded"] = dict(pre=pre, post=ssv_readout(ssv, idx))
    out["world_of_one"] = ref
    return out


def shard_gkp_rank(mesh, runs) -> dict:
    """12c on every rank: each (workload, batch) through
    run_circuit(data_sharding=mesh), first in complex128 (the rows held
    against the serial rows; it also warms the libraries up), then in the
    port's complex64, timed. The world's time is its slowest rank's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, batch in runs:
        circ, coeffs, runner, seed = shard_workload(name)
        with x64_dtype():
            frames128, rho128 = shard_rows(runner, circ, coeffs, batch, seed, mesh)
        mesh_barrier(mesh)
        torch.cuda.reset_peak_memory_stats()
        res = {}
        t = time.perf_counter()
        syncs = count_sync_total(lambda: res.update(
            rows=shard_rows(runner, circ, coeffs, batch, seed, mesh)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        mesh_barrier(mesh)
        mine = torch.tensor([seconds, torch.cuda.max_memory_allocated() / 2**30, syncs],
                            dtype=torch.float64, device=mesh.device)
        per_rank = mesh.all_gather(mine[None]).cpu().numpy()
        out[name] = dict(
            batch=batch, ranks=mesh.size, seconds=float(per_rank[:, 0].max()),
            seconds_per_rank=per_rank[:, 0].tolist(), peak_gib_per_rank=per_rank[:, 1].tolist(),
            syncs_per_rank=per_rank[:, 2].tolist(),
            syncs_per_trajectory=float(per_rank[:, 2].sum() / batch),
            rows=res["rows"], rows128=(frames128, rho128), counts=dict(runner.counts))
    return out


def shard_workload(name: str):
    """(circuit, coefficients, engine, seed) of 12c's RB (bench.py's
    workload) or Grover (10a's cell) run."""
    from quantum_computations_tpu_torch.dv import State
    from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
    if name == "rb":
        _, circ, runner = rb_workload()
        return circ, logical_coeffs([State.ZERO] * 2), runner, RB_SEED
    circ, coeffs = grover_circuit()
    return circ, coeffs, rb_engine(epsilon=db_to_eps(GROVER_DB)), 42


def shard_rows(runner, circ, coeffs, batch, seed, mesh=None):
    """(frames, raw rho as complex128 numpy) of one batch, data sharded
    over ``mesh`` (every rank gets the whole batch's rows)."""
    tensors, frames = runner.run_circuit(circ, coeffs, batch, rng_seed=seed,
                                         data_sharding=mesh)
    re, im = runner.readout(tensors, frames)
    return frames, re.double().cpu().numpy() + 1j * im.double().cpu().numpy()


def shard_check(name: str, ranks: int, r: dict, serial):
    """12c's rows against the serial rows: complex128 within SHARD_ROW_TOL
    with equal frames (the sharded engine computes the serial run's
    trajectories); complex64 reported (other batch sizes take other
    cuBLAS and cuSOLVER kernels), its traces finite and positive."""
    (f128, rho128), (f64, rho64) = serial
    frames, rho = r.pop("rows")
    sf128, srho128 = r.pop("rows128")
    r.update(frames_equal_serial_c128=bool(np.array_equal(sf128, f128)),
             max_abs_rho_diff_to_serial_c128=float(np.abs(srho128 - rho128).max()),
             frames_equal_serial_c64=bool(np.array_equal(frames, f64)),
             max_abs_rho_diff_to_serial_c64=float(np.abs(rho - rho64).max()),
             seconds_per_trajectory=r["seconds"] / r["batch"])
    traces = np.trace(rho, axis1=1, axis2=2).real
    log(f"12c {name} x{ranks}: {r['seconds_per_trajectory']:.4f} s per trajectory "
        f"({r['batch']} in {r['seconds']:.3f} s; per rank "
        f"{[round(x, 3) for x in r['seconds_per_rank']]}); syncs per trajectory "
        f"{r['syncs_per_trajectory']:.2f}; peak per rank "
        f"{[round(x, 3) for x in r['peak_gib_per_rank']]} GiB; complex128 rows: frames "
        f"equal serial {r['frames_equal_serial_c128']}, max |d rho| "
        f"{r['max_abs_rho_diff_to_serial_c128']:.3e} (tol {SHARD_ROW_TOL}); complex64 "
        f"rows: frames equal serial {r['frames_equal_serial_c64']}, max |d rho| "
        f"{r['max_abs_rho_diff_to_serial_c64']:.3e}")
    if not (r["frames_equal_serial_c128"]
            and r["max_abs_rho_diff_to_serial_c128"] <= SHARD_ROW_TOL):
        raise AssertionError(f"12c {name} x{ranks}: complex128 rows differ from the "
                             f"serial rows")
    if not (np.all(np.isfinite(traces)) and np.all(traces > 0)):
        raise AssertionError(f"12c {name} x{ranks}: traces {traces}")


def world_many(mesh, runs) -> dict:
    """12b, then 12c, on every rank of a world of SV_RANKS on one card."""
    out = sv_world_many(mesh)
    torch.cuda.empty_cache()
    out["data_sharded"] = shard_gkp_rank(mesh, runs)
    return out


def world_one(mesh, many: dict, runs) -> dict:
    """12a and 12b's reference, then 12c, on a world of one."""
    out = sv_world_one(mesh, many)
    torch.cuda.empty_cache()
    out["data_sharded"] = shard_gkp_rank(mesh, runs)
    return out


def shard_runs(ranks: int) -> list:
    return [("rb", RB_BATCH)] + ([("grover", SHARD_GROVER_BATCH)]
                                 if ranks in SHARD_GROVER_WORLDS else [])


def sharded_path() -> dict:
    """Phase 12: three worlds (SV_RANKS ranks: 12b and 12c; one rank under
    NCCL: 12a, 12b's reference and 12c; two ranks: 12c)."""
    from quantum_computations_tpu_torch.parallel import launch
    torch.cuda.empty_cache()
    out = {"data_sharded": {}}
    with Phase("12c serial reference rows, complex128 and complex64"):
        serial = {}
        for name, batch in (("rb", RB_BATCH), ("grover", SHARD_GROVER_BATCH)):
            circ, coeffs, runner, seed = shard_workload(name)
            with x64_dtype():
                rows128 = shard_rows(runner, circ, coeffs, batch, seed)
            serial[name] = (rows128, shard_rows(runner, circ, coeffs, batch, seed))
            del runner
        torch.cuda.empty_cache()

    def data_sharded(ranks, res):
        for name, r in res.items():
            shard_check(name, ranks, r, serial[name])
            out["data_sharded"].setdefault(name, {})[ranks] = r

    # the ranks' C++ warnings (every sync of gloo's own threads under the
    # sync debug mode of the syncs count) stay off the output
    os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    try:
        with Phase(f"12b ShardMap and Sharded state vectors at N = {SV_N_WORLD}, then 12c, "
                   f"{SV_RANKS} ranks on one card (gloo)"):
            many = launch(world_many, SV_RANKS, shard_runs(SV_RANKS))
            sm = many["shardmap"]
            log(f"12b collectives on CUDA tensors over {many['collectives']['backend']}: "
                f"{many['collectives']}")
            log(f"12b ShardMap x{SV_RANKS}: mixed circuit and slab plan {sm['seconds']:.3f} "
                f"s, {sm['apply_exchanges']} lazy-swap exchanges, plan {sm['plan']} "
                f"({sm['a2a']} a2a steps); {sm['exchange_ms']:.2f} ms per exchange of "
                f"{sm['half_block_mib']:.0f} MiB; measured qubit {sm['measured']} (rank bit "
                f"0) -> {sm['outcome']}; samples within {sm['sample_worst_se']:.2f} SE; peak "
                f"per rank {many['peak_gib_per_rank']} GiB")
            data_sharded(SV_RANKS, many.pop("data_sharded"))
        with Phase(f"12a ShardMapStateVector({SV_N}), 12b's reference, then 12c, on a "
                   f"world of one (NCCL)"):
            one = launch(world_one, 1, many, shard_runs(1))
            cal, main = one["calibration"], one["main"]
            log(f"12a limits from N = {cal['n']} against complex128: errors "
                f"{cal['errors_to_complex128']}; limits ({SV_LIMIT_HEADROOM:g}x) "
                f"{cal['limits']}")
            log(f"12a N = {SV_N} over {one['backend']}: run_fused_slab of {main['gates']} "
                f"gates {main['seconds']:.3f} s, plan {main['plan']}, state "
                f"{main['state_gib']:.1f} GiB, peak {main['peak_gib']:.2f} GiB; against "
                f"FastStatevector({SV_N}) {main['against_fast_sv']}; measured qubit "
                f"{main['measured']} -> {main['outcome']} (p {main['p_outcome']:.6f}); "
                f"{main['samples']} samples in {main['sample_seconds']:.3f} s, within "
                f"{main['sample_worst_se']:.2f} SE")
            for k, lim in cal["limits"].items():
                if not main["against_fast_sv"][k] <= lim:
                    raise AssertionError(f"12a: {k} {main['against_fast_sv'][k]} against "
                                         f"FastStatevector over its limit {lim}")
            world = {}
            for name in ("shardmap", "sharded"):
                ref = one["world_of_one"][name]
                world[name] = {s: readout_diff(many[name][s], ref[s]) for s in ("pre", "post")}
                for s in ("pre", "post"):  # the arrays stay out of the JSON line
                    many[name][s] = ref[s] = None
            log(f"12b world of {SV_RANKS} against the world of one (tol {SV_WORLD_TOL}): "
                f"{world}; plans {many['shardmap']['plan']} and "
                f"{one['world_of_one']['shardmap']['plan']}")
            worst = max(v for d in world.values() for s in d.values() for v in s.values())
            if not worst <= SV_WORLD_TOL:
                raise AssertionError(f"12b: the world of {SV_RANKS} is {worst} off")
            if many["shardmap"]["a2a"] + many["shardmap"]["apply_exchanges"] < 1:
                raise AssertionError("12b ran no exchange")
            data_sharded(1, one.pop("data_sharded"))
            out.update(sv_world_of_one=one, sv_world_many=many, sv_world_diff=world)
        for ranks in SHARD_WORLDS:
            if ranks not in (1, SV_RANKS):
                with Phase(f"12c data-sharded BatchedGKP, {ranks} ranks on one card (gloo)"):
                    data_sharded(ranks, launch(shard_gkp_rank, ranks, shard_runs(ranks)))
    finally:
        del os.environ["TORCH_CPP_LOG_LEVEL"]
    for name, by_ranks in out["data_sharded"].items():
        base = by_ranks[1]["seconds_per_trajectory"]
        log(f"12c {name}: s per trajectory " + ", ".join(
            f"x{k} {v['seconds_per_trajectory']:.4f} ({base / v['seconds_per_trajectory']:.2f}x)"
            for k, v in sorted(by_ranks.items())))
    return out

# -- phase 13: the batched Hermitian eigensolver of the BS split's Grams ------
EIGH_SHAPES = ((16, 110), (10, 110), (8, 110), (1, 110))  # the split's calls
EIGH_CHECKS = ((1, 1), (3, 2), (2, 3), (10, 32), (16, 33), (1, 110),
               (8, 110), (16, 110), (10, 127), (16, 128))
EIGH_TOL = 1e-12  # eigenvalues, residual and V^H V, relative to ||G||
# 13d: the kernel against torch.linalg.eigh per call at small batches, for
# the crossover below which ops/linalg.py keeps cuSOLVER
EIGH_CROSSOVER_SIDES = (26, 64, 110, 128)
EIGH_CROSSOVER_BATCHES = (1, 2, 3, 4, 6, 8, 16)
EIGH_LOW_BATCHES = (1, 2, 3, 4)  # 13e: RB batches with small split passes


def eigh_inputs(kind: str, B: int, n: int, seed: int) -> torch.Tensor:
    """A (B, n, n) complex128 Hermitian batch on the card: ``herm`` is a
    complex Gaussian one; ``gram`` a PSD Gram whose spectrum falls from 1 to
    1e-30, half of it zero, with ``svd_gram``'s diagonal ramp."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, n, n, dtype=torch.complex128, generator=g)
    if kind == "herm":
        return ((X + X.mH) / 2).cuda()
    Q, _ = torch.linalg.qr(X)
    w = torch.logspace(0, -30, n, dtype=torch.float64)
    w[(n + 1) // 2:] = 0
    G = (Q * w.to(Q.dtype)) @ Q.mH
    tr = G.diagonal(dim1=-2, dim2=-1).sum(-1).real
    G.diagonal(dim1=-2, dim2=-1).add_(
        torch.arange(n, dtype=torch.float64) * (1e-15 * tr / n**2)[:, None])
    return G.cuda()


def eigh_errors(G, w, V, w_ref) -> dict:
    """Each check relative to max|w_ref| or ||G||_F, the worst of the batch."""
    n = G.shape[-1]
    scale = w_ref.abs().amax(-1).clamp_min(1e-300)
    gnorm = torch.linalg.matrix_norm(G).clamp_min(1e-300)
    eye = torch.eye(n, dtype=V.dtype, device=V.device)
    return {
        "eigenvalues": ((w - w_ref).abs().amax(-1) / scale).max().item(),
        "residual": (torch.linalg.matrix_norm(G @ V - V * w[..., None, :])
                     / gnorm).max().item(),
        "orthonormality": (V.mH @ V - eye).abs().max().item(),
        "ascending": bool((w[..., 1:] >= w[..., :-1]).all().item())}


def eigh_small_phase(card: str, main_launches: int | None = None) -> dict:
    """13: ``ops.herm_eigh_small`` built and held against its plain version
    and ``torch.linalg.eigh`` on the card, then timed at the split's shapes
    beside its bound, the plain version and the library call, and against
    the library at small batches, per call and in RB batches of 1 to 4
    trajectories; returns its row of the kernel table, with
    ``main_launches`` (phase 9b's batch) as its launches."""
    from quantum_computations_tpu_torch.ops import _build
    from quantum_computations_tpu_torch.ops import herm_eigh_small as hs

    with Phase("13a herm_eigh_small build"):
        t = time.perf_counter()
        out = _build.build(["herm_eigh_small"])["herm_eigh_small"]
        log(f"built herm_eigh_small in {time.perf_counter() - t:.2f}s, cache hit: {out is None}")
        for line in (out or "").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                log(f"  ptxas: {line.strip()}")
        _build.load("herm_eigh_small")
    with Phase("13b herm_eigh_small vs plain and torch.linalg.eigh"):
        checks = []
        for kind in ("herm", "gram"):
            for B, n in EIGH_CHECKS:
                G = eigh_inputs(kind, B, n, seed=B * 1000 + n)
                before = hs.herm_eigh_small.launches
                w, V, info = hs.herm_eigh_small(G)
                torch.cuda.synchronize()
                if hs.herm_eigh_small.launches != before + 1:
                    raise AssertionError("herm_eigh_small did not launch once")
                w_ref = torch.linalg.eigh(G)[0]
                errs = eigh_errors(G, w, V, w_ref)
                wp, _, info_p = hs.herm_eigh_small_plain(G)
                errs["vs_plain"] = ((w - wp).abs().amax(-1)
                                    / w_ref.abs().amax(-1).clamp_min(1e-300)).max().item()
                errs.update(kind=kind, B=B, n=n, sweeps=info.tolist(),
                            sweeps_plain=info_p.tolist())
                log(f"{kind} B={B} n={n}: sweeps {sorted(set(errs['sweeps']))} "
                    f"(plain {sorted(set(errs['sweeps_plain']))}); eigenvalues "
                    f"{errs['eigenvalues']:.2e}, residual {errs['residual']:.2e}, "
                    f"V^H V - I {errs['orthonormality']:.2e}, vs plain {errs['vs_plain']:.2e}")
                worst = max(errs[key] for key in ("eigenvalues", "residual", "orthonormality",
                                                  "vs_plain"))
                if not (worst <= EIGH_TOL and errs["ascending"]
                        and min(errs["sweeps"]) >= 0):
                    raise AssertionError(f"herm_eigh_small {kind} B={B} n={n}: {errs}")
                checks.append(errs)
        try:
            hs.herm_eigh_small(torch.zeros(1, 129, 129, dtype=torch.complex128, device="cuda"))
            raise AssertionError("n = 129 was taken")
        except ValueError:
            pass
        err = hs._kernel()(0, 0, 0, 0, 1, 110, 7, 8, 40, 1e-15, 0)
        if err == 0:
            raise AssertionError("a launch with null pointers was not refused")
        log(f"n = 129 raises; a launch with null pointers is refused (CUDA error {err})")
    timings = {}
    with Phase("13c herm_eigh_small at the split's shapes"):
        for B, n in EIGH_SHAPES:
            row = {}
            for kind in ("gram", "herm"):
                G = eigh_inputs(kind, B, n, seed=7 * B + n)
                before = hs.herm_eigh_small.launches
                ms = cuda_ms(lambda: hs.herm_eigh_small(G), 10)
                launches = hs.herm_eigh_small.launches - before
                if launches != 11:
                    raise AssertionError(f"{launches} launches for 11 calls")
                sweeps = hs.herm_eigh_small(G)[2]
                lib_ms = cuda_ms(lambda: torch.linalg.eigh(G), 5)
                t = time.perf_counter()
                hs.herm_eigh_small_plain(G)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t) * 1e3
                bound_ms = 36 * n**3 * B / PEAK_FP64_FLOPS * 1e3
                row[kind] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, launches_per_call=launches / 11,
                                 sweeps=sorted(set(sweeps.tolist())),
                                 library_over_kernel=lib_ms / ms)
                log(f"herm_eigh_small B={B} n={n} {kind}: {ms:.3f} ms (sweeps "
                    f"{row[kind]['sweeps']}); library (torch.linalg.eigh) {lib_ms:.3f} ms, "
                    f"{lib_ms / ms:.2f}x the kernel's time; plain {plain_ms:.1f} ms; "
                    f"bound {bound_ms:.4f} ms (36 n^3 FP64 operations a matrix)")
            timings[f"{B}x{n}"] = row
    crossover = {}
    with Phase("13d herm_eigh_small against torch.linalg.eigh at small batches"):
        for n in EIGH_CROSSOVER_SIDES:
            rows = {}
            for B in EIGH_CROSSOVER_BATCHES:
                for kind in ("gram", "herm"):
                    G = eigh_inputs(kind, B, n, seed=11 * B + n)
                    ms = cuda_ms(lambda: hs.herm_eigh_small(G), 10)
                    lib_ms = cuda_ms(lambda: torch.linalg.eigh(G), 10)
                    rows[f"{B} {kind}"] = dict(ms=ms, library_ms=lib_ms)
                log(f"herm_eigh_small n={n} B={B}: graded {rows[f'{B} gram']['ms']:.3f} ms "
                    f"(library {rows[f'{B} gram']['library_ms']:.3f}), random "
                    f"{rows[f'{B} herm']['ms']:.3f} ms (library "
                    f"{rows[f'{B} herm']['library_ms']:.3f})")
            wins = [B for B in EIGH_CROSSOVER_BATCHES
                    if all(rows[f"{B} {kind}"]["ms"] < rows[f"{B} {kind}"]["library_ms"]
                           for kind in ("gram", "herm"))]
            crossover[n] = dict(rows=rows, kernel_faster_at=wins)
            log(f"n={n}: the kernel is faster on both kinds at B in {wins}")
    low = {}
    with Phase("13e RB batches with small split passes, kernel against library"):
        from quantum_computations_tpu_torch.ops import linalg
        _, gkp_circ, runner = rb_workload()
        for batch in EIGH_LOW_BATCHES:
            for route, min_batch in (("kernel", 1), ("library", 10**9)):
                with patched(linalg, "KERNEL_MIN_BATCH", min_batch):
                    rb_run(runner, gkp_circ, batch=batch, seed=RB_SEED + 1)
                    torch.cuda.synchronize()
                    times = []
                    for rep in range(2):
                        t = time.perf_counter()
                        rb_run(runner, gkp_circ, batch=batch, seed=RB_SEED + 2 + rep)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t)
                low[f"{batch} {route}"] = times
            log(f"RB batch {batch}: s per batch by the kernel {low[f'{batch} kernel']}, "
                f"by torch.linalg.eigh {low[f'{batch} library']}")
    print(json.dumps({"eigh_small": {"checks": checks, "timings": timings,
                                     "crossover": crossover, "low_batch_rb": low},
                      "card": card}), flush=True)
    main_row = timings["16x110"]["gram"]
    return {"name": "herm_eigh_small", "route": "cuda",
            "source": "quantum_computations_tpu_torch/ops/csrc/herm_eigh_small.cu",
            "replaces": "none (torch.linalg.eigh of the split's Grams)",
            "launches": main_launches, "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": "latency (operations bound given)",
            "library_ms": main_row["library_ms"], "by_shape": timings}


def eigh_small_main() -> int:
    """Phase 13 alone: ``python -c 'import chip_smoke as c; c.eigh_small_main()'``."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    row = eigh_small_phase(card)
    print(json.dumps({"kernels": [row]}, default=str), flush=True)
    return 0




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from quantum_computations_tpu_torch.dv import FastStatevector, gates, qop
    from quantum_computations_tpu_torch.dv import fast_sv
    from quantum_computations_tpu_torch.ops import _build, slab_kernels as sk
    from quantum_computations_tpu_torch.ops import gate_kernels as gk

    with Phase("0 card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    with Phase("1 build"):
        t = time.perf_counter()
        logs = _build.build(["slab_matmul", "gate_mix", "chain_mix"])
        for name, out in logs.items():
            log(f"built {name} in {time.perf_counter() - t:.2f}s, cache hit: "
                f"{out is None}")
            for line in (out or "").splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    log(f"  ptxas: {line.strip()}")

    with Phase("2 kernel vs plain"):
        for d in (32, 64, 128):  # d <= 32: FFMA; d >= 64: 3xTF32
            for rows in (1, 3, 1 << 14, 1 << 20):
                re, im = random_planes(rows * d, seed=rows + d)
                wt = random_window(d, seed=d)
                tc0 = sk.slab_matmul.tensor_core_launches
                err, rel = kernel_vs_plain(sk.slab_matmul,
                                           sk.slab_matmul_plain, re, im, *wt)
                tc = sk.slab_matmul.tensor_core_launches - tc0
                log(f"slab_matmul d={d} rows={rows}: max abs err {err:.3e}, "
                    f"rel {rel:.3e} (tol {KERNEL_RTOL} x max|plain|), "
                    f"tensor cores {bool(tc)}, launches so far "
                    f"{sk.slab_matmul.launches}")
                if tc != (d >= 64):
                    raise AssertionError(f"slab_matmul d={d} ran the "
                                         f"{'3xTF32' if tc else 'FFMA'} path")
        del re, im, wt  # phase 4 reads the peak memory of the engine alone

    with Phase("2b gate kernels vs plain"):
        rng = np.random.default_rng(11)
        n = 20
        for kernel, plain, span in ((gk.apply_1q, gk.apply_1q_plain, 1),
                                    (gk.apply_2q_adjacent,
                                     gk.apply_2q_adjacent_plain, 2)):
            for q in (0, n // 2, n - span):
                re, im = random_planes(1 << n, seed=q + span)
                err, rel = kernel_vs_plain(kernel, plain, re, im,
                                           random_unitary(1 << span, rng),
                                           q, n)
                log(f"{kernel.__name__} N={n} q={q}: max abs err {err:.3e}, "
                    f"rel {rel:.3e} (tol {KERNEL_RTOL} x max|plain|), "
                    f"launches so far {kernel.launches}")
        for n in (12, 14, 20):
            for k in (1, 9, 24):
                # the planner's bits and one outside them, with repeats
                pool = list(gk.fusable_bits(n)) + [0, n - 1]
                bits = tuple(int(b) for b in rng.choice(pool, k))
                us = np.stack([random_unitary(2, rng) for _ in bits])
                re, im = random_planes(1 << n, seed=n + k)
                err, rel = kernel_vs_plain(gk.apply_1q_chain,
                                           gk.apply_1q_chain_plain, re, im,
                                           us, bits, n)
                log(f"apply_1q_chain N={n} k={k} bits={bits}: max abs err "
                    f"{err:.3e}, rel {rel:.3e} (tol {KERNEL_RTOL} x "
                    f"max|plain|), launches so far "
                    f"{gk.apply_1q_chain.launches}")
        del re, im

    with Phase("3 engine vs dense reference"):
        rng = np.random.default_rng(3)
        circuit = []
        for layer in range(6):
            for q in range(N_CHECK):
                axis = rng.normal(size=3)
                circuit.append((qop.axis_rotation(rng.uniform(0, 2 * np.pi),
                                                  axis / np.linalg.norm(axis)),
                                (q,)))
            for _ in range(4):
                a, b = (int(x) for x in rng.choice(N_CHECK, 2, replace=False))
                circuit.append(gates.CZ(a, b) if layer % 2 else gates.CX(a, b))
        want = dense_reference(circuit, N_CHECK)
        for label, attrs, runner in (
                ("run", {}, "run"), ("run_compiled", {}, "run_compiled"),
                ("minor-safe moves S=4", dict(slab_bits=4, scatter_move_max=0),
                 "run_compiled")):
            sv = FastStatevector(N_CHECK, device="cuda")
            for k, v in attrs.items():
                setattr(sv, k, v)
            getattr(sv, runner)(circuit)
            got = logical_amplitudes(sv)
            fid = abs(np.vdot(want, got)) ** 2
            log(f"N={N_CHECK} {label}: {len(circuit)} gates, layout passes "
                f"{sv.layout_passes}, fidelity {fid:.9f}")
            if not fid > 1 - 1e-5:
                raise AssertionError(f"fidelity {fid} <= 1 - 1e-5 ({label})")

    with Phase("3b chain engine vs dense reference"):
        rng = np.random.default_rng(13)
        circuit = []
        for layer in range(4):
            for q in range(N_CHECK):  # qubits 0..6 chain, 7..13 apply_1q
                axis = rng.normal(size=3)
                circuit.append((qop.axis_rotation(rng.uniform(0, 2 * np.pi),
                                                  axis / np.linalg.norm(axis)),
                                (q,)))
            circuit += [gates.CZ(q, q + 1) for q in range(layer, 6)]  # 2q
            circuit += [gates.CX(5, 2), gates.CX(9, 10), gates.SWAP(11, 3),
                        (random_unitary(8, rng), (12, 1, 6))]  # general
        want = dense_reference(circuit, N_CHECK)
        sv = FastStatevector(N_CHECK, device="cuda", fusion_mode="chain")
        kinds = [p.kind for p in sv._plan(circuit)]
        sv.run(circuit)
        fid = abs(np.vdot(want, logical_amplitudes(sv))) ** 2
        log(f"N={N_CHECK} chain mode: {len(circuit)} gates, plan kinds "
            f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, fidelity "
            f"{fid:.9f}")
        if not fid > 1 - 1e-5:
            raise AssertionError(f"chain-mode fidelity {fid} <= 1 - 1e-5")
        if set(kinds) != {"chain", "2q", "xla"}:
            raise AssertionError(f"the N={N_CHECK} circuit planned {kinds}")
        del sv

    # -- the main path at full width --------------------------------------
    H = np.asarray(qop.H)
    spread = list(dict.fromkeys((3 + 2 * i) % (N_FULL - 1) for i in range(14)))
    h_chain = [(H, (q,)) for q in (spread * 2)[:24]]
    T = np.asarray(qop.T)
    resident_chain = ([(H, (q,)) for q in range(N_FULL - 7, N_FULL)]
                      + [(T, (q,)) for q in range(N_FULL - 7, N_FULL)])
    chains = (("a: 24 H on 14 qubits", h_chain),
              ("b: slab-resident 7 H + 7 T", resident_chain))
    main = {}
    torch.cuda.reset_peak_memory_stats()
    sk.slab_matmul.launches = 0
    sk.slab_matmul.tensor_core_launches = 0
    with Phase(f"4 main path N={N_FULL}"):
        for label, chain in chains:
            sv = FastStatevector(N_FULL, device="cuda")  # identity layout
            for _ in range(3):
                sv.run_compiled(chain)
            torch.cuda.synchronize()
            passes0, launches0 = sv.layout_passes, sk.slab_matmul.launches
            t = time.perf_counter()
            for _ in range(REPS):
                sv.run_compiled(chain)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / REPS * 1e3
            norm_err = abs(sv.norm_sq() - 1.0)
            main[label] = dict(
                ms_per_chain=ms, ms_per_gate=ms / len(chain),
                layout_passes_per_chain=(sv.layout_passes - passes0) / REPS,
                launches_per_chain=(sk.slab_matmul.launches - launches0) / REPS)
            log(f"N={N_FULL} chain {label}: {ms:.3f} ms/chain, "
                f"{ms / len(chain):.4f} ms/gate, layout passes/chain "
                f"{main[label]['layout_passes_per_chain']}, kernel "
                f"launches/chain {main[label]['launches_per_chain']}, "
                f"|norm_sq - 1| {norm_err:.2e}")
            if not norm_err < 1e-3:
                raise AssertionError(f"|norm_sq - 1| = {norm_err} >= 1e-3")
            del sv
    main_launches = sk.slab_matmul.launches
    main_tc_launches = sk.slab_matmul.tensor_core_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: slab_matmul launches {main_launches} (3xTF32 tensor "
        f"cores {main_tc_launches}), max_memory_allocated {peak_gib:.2f} GiB")
    print(json.dumps({"main_path": main, "n_qubits": N_FULL,
                      "max_memory_allocated_gib": peak_gib}), flush=True)
    if main_launches < 1:
        raise AssertionError("the main path launched no slab_matmul kernel")
    if main_tc_launches != main_launches:
        raise AssertionError(f"only {main_tc_launches} of the main path's "
                             f"{main_launches} d=128 windows ran on the "
                             f"tensor cores")

    # -- the chain-mode path at full width ---------------------------------
    # circuit c (at N = 30): 24 random rotations on qubits 14..22 (bits
    # 15..7, one chain), CZ(q, q+1) for q = 14..21 (eight 2q steps), and a
    # rotation R of qubit 29 by pi/16 (bit 0, not fusable: one general
    # step, which runs the apply_1q kernel). R is not its own inverse, so
    # qubit 29's P(0) after the counted runs tells how often R ran.
    rng = np.random.default_rng(29)
    q0 = N_FULL - 16  # qubit of bit 15
    chain_qubits = list(range(q0, q0 + 9)) + [int(q) for q in
                                              rng.integers(q0, q0 + 9, 15)]
    rng.shuffle(chain_qubits)
    circuit_c = [(random_unitary(2, rng), (q,)) for q in chain_qubits]
    circuit_c += [gates.CZ(q, q + 1) for q in range(q0, q0 + 8)]
    r_last = qop.axis_rotation(np.pi / 16, np.ones(3) / np.sqrt(3))
    circuit_c += [(r_last, (N_FULL - 1,))]
    cx_general = gates.CX(N_FULL - 1, q0)  # a 2-qubit general step, unsorted
    gate_kernels = (gk.apply_1q_chain, gk.apply_2q_adjacent, gk.apply_1q)
    runs = WARMUP + REPS
    torch.cuda.reset_peak_memory_stats()
    with Phase(f"4b chain-mode path N={N_FULL}"):
        sv = FastStatevector(N_FULL, device="cuda", fusion_mode="chain")
        plan = sv._plan(circuit_c)
        kinds = [p.kind for p in plan]
        planned = {"chain": kinds.count("chain"), "2q": kinds.count("2q"),
                   "general": kinds.count("xla")}
        if planned != {"chain": 1, "2q": 8, "general": 1}:
            raise AssertionError(f"circuit c planned {planned}")
        for kernel in gate_kernels:
            kernel.launches = 0
        for _ in range(WARMUP):
            sv.run(circuit_c)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REPS):
            sv.run(circuit_c)
        torch.cuda.synchronize()
        chain_ms = (time.perf_counter() - t) / REPS * 1e3
        chain_launches = {k.__name__: k.launches for k in gate_kernels}
        # the runs' peak, before the readouts below add their temporaries
        peak_chain_gib = torch.cuda.max_memory_allocated() / 2**30
        per_run = {name: n / runs for name, n in chain_launches.items()}
        if per_run != {"apply_1q_chain": 1, "apply_2q_adjacent": 8,
                       "apply_1q": 1}:
            raise AssertionError(f"launches per run {per_run} differ from "
                                 f"the plan {planned}")
        norm_err = abs(sv.norm_sq() - 1.0)
        # qubits 0..13 and 23..28 stay |0>; qubit 29 is R^runs |0>
        p_untouched = [sv.probabilities(q)[0].item()
                       for q in (0, q0 - 1, q0 + 9, N_FULL - 2)]
        p_last = sv.probabilities(N_FULL - 1)[0].item()
        p_last_want = abs(np.linalg.matrix_power(r_last, runs)[0, 0]) ** 2
        log(f"N={N_FULL} circuit c ({len(circuit_c)} gates): {chain_ms:.3f} "
            f"ms/run, {chain_ms / len(circuit_c):.4f} ms/gate; plan "
            f"{planned}; launches per run {per_run}; |norm_sq - 1| "
            f"{norm_err:.2e}; P(0) of untouched qubits {p_untouched}; P(0) "
            f"of qubit {N_FULL - 1} {p_last:.7f} (R^{runs}: "
            f"{p_last_want:.7f}); max_memory_allocated "
            f"{peak_chain_gib:.2f} GiB")
        if not norm_err < 1e-3:
            raise AssertionError(f"|norm_sq - 1| = {norm_err} >= 1e-3")
        if not min(p_untouched) > 1 - 1e-4:
            raise AssertionError(f"untouched qubits left |0>: {p_untouched}")
        if not abs(p_last - p_last_want) < 1e-4:
            raise AssertionError(f"P(0) of qubit {N_FULL - 1} is {p_last}, "
                                 f"R^{runs} gives {p_last_want}")
        # a general step of two qubits (plain torch, out of place) through
        # the engine: its time per run and its peak memory, then one more
        # application held against the snapshot it permutes
        if [p.kind for p in sv._plan([cx_general])] != ["xla"]:
            raise AssertionError(f"{cx_general} is not a general step")
        torch.cuda.synchronize()
        resident_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        general_ms = cuda_ms(lambda: sv.run([cx_general]), 2)
        general_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        snap = (sv.re.clone(), sv.im.clone())
        sv.run([cx_general])
        general_err = cx_expected_diff(sv.re, sv.im, *snap, N_FULL - 1, q0,
                                       N_FULL)
        del snap
        log(f"general step CX({N_FULL - 1}, {q0}) through run: "
            f"{general_ms:.3f} ms; max_memory_allocated {general_peak_gib:.2f}"
            f" GiB (planes {resident_gib:.2f} GiB); max abs err against the "
            f"permuted snapshot {general_err:.3e}")
        if not general_err <= 1e-6:
            raise AssertionError(f"the general step CX is off by "
                                 f"{general_err}")
        # each step of circuit c alone, on the engine's planes (outside the
        # counted run): the path's time by kernel
        steps = {
            "apply_1q_chain": lambda: gk.apply_1q_chain(
                sv.re, sv.im, np.stack(plan[0].matrices), tuple(plan[0].bits),
                N_FULL),
            "apply_2q_adjacent": lambda: gk.apply_2q_adjacent(
                sv.re, sv.im, plan[1].matrices[0], plan[1].targets[0], N_FULL),
            "apply_1q": lambda: gk.apply_1q(
                sv.re, sv.im, plan[-1].matrices[0], plan[-1].targets[0],
                N_FULL)}
        step_ms = {name: cuda_ms(fn, 3) for name, fn in steps.items()}
        shares = {name: step_ms[name] * per_run[name] / chain_ms
                  for name in step_ms}
        log(f"circuit c by step: ms per launch {step_ms}; share of the run "
            f"{shares}; rest (host, derived) "
            f"{chain_ms - sum(step_ms[k] * per_run[k] for k in step_ms):.3f} ms")
        del sv
    print(json.dumps({"chain_path": {
        "ms_per_run": chain_ms, "ms_per_gate": chain_ms / len(circuit_c),
        "gates": len(circuit_c), "planned": planned,
        "launches_per_run": per_run, "step_ms": step_ms, "shares": shares,
        "max_memory_allocated_gib": peak_chain_gib,
        "general_step": {"gate": f"CX({N_FULL - 1}, {q0})",
                         "ms": general_ms, "max_abs_err": general_err,
                         "max_memory_allocated_gib": general_peak_gib,
                         "resident_gib": resident_gib}}}), flush=True)

    with Phase(f"5 kernel at the main path's shape (N={N_FULL}, d=128)"):
        d = 128
        n = 1 << N_FULL
        rows = n // d
        re, im = random_planes(n, seed=5)
        wt_re, wt_im = random_window(d, seed=7)
        err, rel = kernel_vs_plain(sk.slab_matmul, sk.slab_matmul_plain,
                                   re, im, wt_re, wt_im)
        log(f"slab_matmul at N={N_FULL}: max abs err {err:.3e}, rel {rel:.3e}")
        tc0 = sk.slab_matmul.tensor_core_launches
        ms = cuda_ms(lambda: sk.slab_matmul(re, im, wt_re, wt_im), 5)
        if sk.slab_matmul.tensor_core_launches - tc0 != 6:
            raise AssertionError("slab_matmul at d=128 left the tensor cores")
        plain_ms = cuda_ms(lambda: sk.slab_matmul_plain(re, im, wt_re, wt_im), 3)
        swap = fast_sv._block_swap_plan(N_FULL, 7)[0]
        swap_ms = cuda_ms(lambda: fast_sv._permute_copy(re, *swap), 3)
        log(f"layout pass (slab<->B block swap) per plane: {swap_ms:.3f} ms; "
            f"bytes bound {2 * n * 4 / PEAK_BYTES_PER_S * 1e3:.3f} ms")
        xc = torch.complex(re, im).reshape(rows, d)
        del re, im
        wtc = torch.complex(wt_re, wt_im)
        library_ms = cuda_ms(lambda: torch.matmul(xc, wtc), 3)
        del xc
        # 3xTF32: three TF32 products of the (R, 2d) x (2d, 2d) real GEMM
        bytes_ms = (4 * n * 4 + 2 * d * d * 4) / PEAK_BYTES_PER_S * 1e3
        ops_ms = 3 * 8 * rows * d * d / PEAK_TF32_FLOPS * 1e3
        ffma_ms = 8 * rows * d * d / PEAK_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"slab_matmul per window: {ms:.3f} ms; bound {bound_ms:.3f} ms "
            f"(3xTF32 operations {ops_ms:.3f}, bytes {bytes_ms:.3f}; the "
            f"same product on FP32 FFMA {ffma_ms:.3f}); plain {plain_ms:.3f} "
            f"ms; library (one complex64 torch.matmul) {library_ms:.3f} ms, "
            f"{library_ms / ms:.2f}x the kernel's time")

    kernels = [{
        "name": "slab_matmul", "route": "cuda",
        "source": "quantum_computations_tpu_torch/ops/csrc/slab_matmul.cu",
        "replaces": "quantum_computations_tpu/ops/pallas_kernels.py:254",
        "launches": main_launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms}]

    with Phase(f"6 gate kernels at the chain path's shapes (N={N_FULL})"):
        n = 1 << N_FULL
        rng = np.random.default_rng(31)
        plane_bytes = 4 * n * 4  # both planes read and written once
        k = 24
        u1, u2 = random_unitary(2, rng), random_unitary(4, rng)
        us = np.stack([random_unitary(2, rng) for _ in range(k)])
        bits = tuple(range(15, 6, -1)) * 2 + tuple(range(7, 13))
        # the chain kernel applies one composed mix per distinct bit
        n_mix = len(set(bits))
        # (name, kernel, plain, source, replaces, args at the path's shape,
        #  bound, library operator (mat, lo, w), args also timed)
        cases = (
            ("apply_1q", gk.apply_1q, gk.apply_1q_plain, "gate_mix.cu",
             "pallas_kernels.py:31", (u1, N_FULL - 1, N_FULL),
             bound(plane_bytes + 32, (n // 2) * 32), (u1, 0, 1),
             (u1, 15, N_FULL)),
            ("apply_2q_adjacent", gk.apply_2q_adjacent,
             gk.apply_2q_adjacent_plain, "gate_mix.cu",
             "pallas_kernels.py:104", (u2, q0, N_FULL),
             bound(plane_bytes + 128, (n // 4) * 128),
             (u2, N_FULL - q0 - 2, 2), None),
            ("apply_1q_chain", gk.apply_1q_chain, gk.apply_1q_chain_plain,
             "chain_mix.cu", "pallas_kernels.py:219", (us, bits, N_FULL),
             bound(plane_bytes + 36 * k, n_mix * (n // 2) * 32),
             chain_operator(us, bits), None))
        for (name, kernel, plain, src, replaces, args, (b_ms, b_by), lib,
             also) in cases:
            re, im = random_planes(n, seed=len(kernels))
            k_err, k_rel = kernel_vs_plain(kernel, plain, re, im, *args)
            k_ms = cuda_ms(lambda: kernel(re, im, *args), 5)
            also_ms = (cuda_ms(lambda: kernel(re, im, *also), 5)
                       if also is not None else None)
            k_plain_ms = cuda_ms(lambda: plain(re, im, *args), 3)
            # one complex64 torch.matmul of the same function, held against
            # the kernel on the same inputs, then timed
            call = library_call(*lib, N_FULL)
            xc = torch.complex(re, im)
            want = call(xc)
            kernel(re, im, *args)
            lib_err = max(
                (want.real - re.view(want.shape)).abs().max().item(),
                (want.imag - im.view(want.shape)).abs().max().item())
            lib_scale = want.abs().max().item()
            del want, re, im
            if not lib_err <= KERNEL_RTOL * lib_scale:
                raise AssertionError(f"the library call of {name} disagrees "
                                     f"with the kernel: {lib_err:.3e}")
            lib_ms = cuda_ms(lambda: call(xc), 3)
            del xc, call
            gates_ms = (k * (n // 2) * 32 / PEAK_FP32_FLOPS * 1e3
                        if kernel is gk.apply_1q_chain else None)
            log(f"{name} at N={N_FULL}, args {args[1:]}: max abs err "
                f"{k_err:.3e}, rel {k_rel:.3e}; {k_ms:.3f} ms per launch"
                + (f" ({also_ms:.3f} ms at args {also[1:]})"
                   if also is not None else "")
                + f"; bound {b_ms:.3f} ms ({b_by}); plain {k_plain_ms:.3f} "
                f"ms; library (one complex64 torch.matmul, (2^{lib[2]})^2 "
                f"operator on bits {lib[1]}..{lib[1] + lib[2] - 1}) "
                f"{lib_ms:.3f} ms, max abs diff to the kernel {lib_err:.3e}"
                + (f"; bound from {n_mix} composed mixes; the {k} gates one "
                   f"by one would be {gates_ms:.3f} ms of FP32 operations"
                   if gates_ms is not None else ""))
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"quantum_computations_tpu_torch/ops/csrc/{src}",
                "replaces": f"quantum_computations_tpu/ops/{replaces}",
                "launches": chain_launches[name], "max_abs_err": k_err,
                "ms": k_ms, "plain_ms": k_plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms})

    cv = cv_path()
    print(json.dumps({"cv_path": cv, "card": card}), flush=True)
    gkp_result = gkp_path()
    print(json.dumps({"gkp_path": gkp_result, "card": card}), flush=True)
    rb_result = rb_path()
    print(json.dumps({"rb_path": rb_result, "card": card}), flush=True)
    grover_result = grover_path()
    print(json.dumps({"grover_path": grover_result, "card": card}, default=float), flush=True)
    threads_result = threads_path()
    print(json.dumps({"threads_path": threads_result, "card": card}, default=float), flush=True)
    ec_result = ec_path()
    print(json.dumps({"ec_path": ec_result, "card": card}, default=float), flush=True)
    sharded_result = sharded_path()
    print(json.dumps({"sharded_path": sharded_result, "card": card}, default=float), flush=True)
    kernels.append(eigh_small_phase(card, rb_result["herm_eigh_small_launches"]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
