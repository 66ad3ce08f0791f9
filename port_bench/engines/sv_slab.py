"""The state-vector engine in slab mode, ``dv/fast_sv.FastStatevector``,
as the harness drives it.

A client is one ``FastStatevector`` of the configuration's width in slab
mode, made once. A job (``drivers/qv_fixed.Job``) is one circuit of
two-qubit gates. Running it is the engine's ``reset`` to |0...0> (in
place), ``run_compiled`` and three readouts to the host: the amplitudes at
the job's logical basis states, ``shots`` samples from a card generator
seeded by the job's seed, and the squared norm. A circuit fails where an
amplitude is not finite or the squared norm is off 1 by more than
``NORM_TOL``. The check works each checked circuit out again with the
benchmark's plain reference (``reference/statevector.simulate``) in
complex128 on the same device, and holds the timed path's own outputs
against it:

- ``amp_rel_err``: ||a_port - a_ref||_2 / ||a_ref||_2 over the amplitudes
  the timed run read out;
- ``xeb_dev``: |F_XEB - 1| over the timed run's samples x, with F_XEB the
  linear cross-entropy fidelity normalised by the reference state,
  (2^N * mean p_ref(x) - 1) / (2^N * sum p_ref^2 - 1): 1 in expectation for
  samples drawn from the state, with a standard deviation of about 0.044
  at 1024 shots for a scrambled one (where 2^N * sum p_ref^2 is about 2 and
  this is 2^N * mean p_ref(x) - 1), and about 0 for samples that do not
  follow it (bits remapped wrongly). The normalisation keeps the reading
  unbiased at the tests' small widths, where a state is not yet
  Porter-Thomas distributed.
"""

from __future__ import annotations

import numpy as np

NORM_TOL = 1e-3
# the CPU runs only the tests' small widths: planes of 2^30 floats and the
# check's two complex128 vectors (32 GiB) belong on the card
CPU_MAX_QUBITS = 20
_CHUNK = 1 << 24


def make_engines(config: dict, traffic: dict, device, clients: int) -> list:
    """One ``FastStatevector`` per client at the configuration's width."""
    import torch

    from port_bench.metrics import slab_work
    from quantum_computations_tpu_torch.dv import FastStatevector

    N = int(config["qubits"])
    if torch.device(device).type == "cpu" and N > CPU_MAX_QUBITS:
        raise ValueError(f"{N} qubits on the CPU: above {CPU_MAX_QUBITS} this engine "
                         "runs on a card (override 'qubits' for a CPU run)")
    slab_work.clear()
    return [FastStatevector(N, device=device, fusion_mode=config["fusion_mode"])
            for _ in range(clients)]


def _counts(sv) -> dict:
    return {"slab_windows": sv.slab_windows, "plane_copies": sv.plane_copies,
            "layout_bytes": sv.layout_bytes, "layout_passes": sv.layout_passes}


def run_job(engine, job):
    """(amplitudes (k,) complex64, (samples (shots,) int64, norm_sq), failed)."""
    import torch

    from port_bench.metrics import slab_work

    traced = torch.autograd.profiler._is_profiler_enabled  # the flag the port's spans read
    before = _counts(engine)
    engine.reset().run_compiled(job.gates)
    amps = engine.amplitudes(job.indices)
    generator = torch.Generator(device=engine.device).manual_seed(job.seed)
    samples = engine.sample(generator, job.shots)
    norm = engine.norm_sq()
    if traced:
        after = _counts(engine)
        slab_work.note({"N": engine.N, "d": 1 << engine.slab_bits,
                        **{k: after[k] - before[k] for k in ("plane_copies", "layout_bytes")}})
    failed = int(not np.all(np.isfinite(amps)) or not abs(norm - 1.0) <= NORM_TOL)
    return amps, (samples, norm), failed


def recorder():
    """The check needs no record of the window."""
    from port_bench.harness.loop import NullRecorder

    return NullRecorder()


def readings(job, amps, samples, psi) -> tuple[float, float]:
    """(amp_rel_err, xeb_dev) of a timed circuit's outputs against the
    reference state ``psi`` (logical order, on any device)."""
    import torch

    at = torch.from_numpy(np.asarray(job.indices, np.int64)).to(psi.device)
    a_ref = psi[at].cpu().numpy()
    drawn = torch.from_numpy(np.asarray(samples, np.int64)).to(psi.device)
    p_ref = (psi[drawn].abs() ** 2).cpu().numpy()
    collision = 0.0  # sum p_ref^2, a chunk at a time
    for s in range(0, psi.numel(), _CHUNK):
        p = psi[s:s + _CHUNK].abs() ** 2
        collision += float(torch.sum(p * p))
    err = np.linalg.norm(amps.astype(np.complex128) - a_ref) / np.linalg.norm(a_ref)
    xeb = (2.0**job.N * float(np.mean(p_ref)) - 1.0) / (2.0**job.N * collision - 1.0)
    return float(err), abs(xeb - 1.0)


def check(batches, chosen, config: dict, traffic: dict, limits: dict, device, log, rng) -> dict:
    """The largest ``amp_rel_err`` and ``xeb_dev`` over the checked circuits."""
    import torch

    from port_bench.reference.statevector import simulate

    errs, devs = [], []
    for i in chosen:
        b = batches[i]
        psi = simulate(b.job.gates, b.job.N, device)
        err, dev = readings(b.job, b.out, b.aux[0], psi)
        del psi
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        log(f"checked circuit {i}: amp_rel_err {err:.3e}, xeb_dev {dev:.4f}, "
            f"norm_sq {b.aux[1]:.7f}")
        errs.append(err)
        devs.append(dev)
    worst = {"amp_rel_err": float(np.max(errs)), "xeb_dev": float(np.max(devs))}  # NaN stays
    return {name: {"value": worst[name], "limit": limits[name]} for name in limits}


def describe(engines) -> str:
    sv = engines[0]
    return f"engine counts {_counts(sv)}; layout {sv.axis_of}"
