"""The port's ``parallel`` package (meshes, ``ShardedStateVector``, sweeps,
``launch``) and ``BatchedGKP.run_circuit(data_sharding=)`` against the JAX
package, case for case with ``tests/test_parallel.py``, on the CPU at
complex128.

The port runs on gloo worlds of D = 2, 4 and 8 ranks (and 1 for the
data-sharded engine), one world per D for the whole file, in a
module-scoped fixture that runs every case on every rank and returns rank
0's results; the JAX package runs on ``qubit_mesh(k, jax.devices()[:D])``
and ``data_mesh(jax.devices()[:D])`` of the 8-device virtual CPU mesh, on
the same numpy-seeded gates, at 1e-10. A sampled measurement draws from a
torch generator, so JAX's engine is post-selected on the port's outcome.

The data-sharded engine runs ``random_circ(2, 2, default_rng(123))`` (an
identity gadget, a Pdg gadget and a SWAP macronode) at d = 256, cap 8,
batch 4: on every world its rows equal the serial port run of the same
seed, and, with the JAX engine's draws and sketches replayed (the
recording harness of ``tests/test_torch_batched_gkp.py``), JAX's
``run_circuit(data_sharding=NamedSharding(...))`` rows. Ranks import this
module to find their functions, so JAX is imported inside the reference
helpers only.
"""

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.dv import State as TDV, qop
from quantum_computations_tpu_torch.gkp import db2eps
from quantum_computations_tpu_torch.gkp.batched import BatchedGKP
from quantum_computations_tpu_torch.gkp.compiled import logical_coeffs
from quantum_computations_tpu_torch.parallel import (
    ShardedStateVector, batched_sweep, data_mesh, launch, qubit_mesh, sharded_sweep,
)
from quantum_computations_tpu_torch.pipelines.rb import random_circ
import quantum_computations_tpu_torch.gkp.batched as tbatched
import quantum_computations_tpu_torch.ops.linalg as tlinalg

TOL = 1e-10
WORLDS = (2, 4, 8)
GKP_WORLDS = (1, 2, 4)
GKP_QS = np.linspace(-20, 20, 256)
GKP_OPTS = {"max_bond_dim": 8, "rel_err": 1e-2}
GKP_BATCH = 4
GKP_SEED = 3


def rand_u(rng, d):
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, _ = np.linalg.qr(a)
    return q


def dense_run(N, circuit):
    """Dense numpy reference: big-endian qubits, tensordot per gate."""
    psi = np.zeros((2,) * N, complex)
    psi.flat[0] = 1.0
    for m, t in circuit:
        k = len(t)
        op = np.asarray(m, complex).reshape((2,) * (2 * k))
        psi = np.tensordot(op, psi, axes=(list(range(k, 2 * k)), list(t)))
        psi = np.moveaxis(psi, list(range(k)), list(t))
    return psi.reshape(-1)


def c_random():
    """The JAX test's circuit: local axes, sharded axes and cross axes."""
    rng = np.random.default_rng(0)
    return 10, [(qop.H, (0,)), (qop.H, (5,)), (rand_u(rng, 4), (0, 9)),
                (qop.CZ, (1, 2)), (rand_u(rng, 2), (7,)), (rand_u(rng, 4), (2, 6)),
                (qop.CX, (0, 1)), (rand_u(rng, 4), (8, 3))]


def c_layers():
    N = 8
    return N, ([(qop.H, (i,)) for i in range(N)]
               + [(qop.CZ, (i, i + 1)) for i in range(N - 1)])


def c_ghz():
    return 6, [(qop.H, (0,))] + [(qop.CX, (0, t)) for t in range(1, 6)]


def traj_square(g):
    x = torch.randn((), generator=g, dtype=torch.float64)
    return x * x


def traj_coin(g):
    return (torch.rand((), generator=g, dtype=torch.float64) < 0.5).to(torch.float32)


def traj_pair(g):
    return torch.randn(2, generator=g, dtype=torch.float64), torch.randint(
        10, (), generator=g)


# ---------------------------------------------------------------------------
# the data-sharded engine
# ---------------------------------------------------------------------------

def _gkp_circuit():
    return random_circ(2, 2, np.random.default_rng(123))[1]


def _gkp_run(mesh=None):
    runner = BatchedGKP(GKP_QS, float(db2eps(10.0)), GKP_OPTS, adaptive=True,
                        granularity="op", device="cpu")
    tensors, frames = runner.run_circuit(_gkp_circuit(), logical_coeffs([TDV.ZERO] * 2),
                                         GKP_BATCH, rng_seed=GKP_SEED, data_sharding=mesh)
    re, im = runner.readout(tensors, frames)
    return dict(frames=frames, rho=(re + 1j * im).numpy(),
                shapes=[tuple(t.shape) for t in tensors], counts=dict(runner.counts))


def _replay_sharded(mp, rec, lo, hi, total):
    """Feed the JAX engine's recorded indices and sketches to this rank:
    a fused gadget takes its rows of the batch's recorded indices; the
    sketches are replayed in call order, which a sharded run keeps (it
    draws, and drops, every other trajectory's sketch too)."""
    real_fsg, real_fpm = tbatched.fused_single_gadget, tbatched.fused_pair_measure2

    def forced(kind):
        rows = [rec[kind].pop(0) for _ in range(total)][lo:hi]
        return tuple(np.asarray(col) for col in zip(*rows))

    def fsg(tensors, idx, qs, bell, a1, a2, generator=None, **kw):
        return real_fsg(tensors, idx, qs, bell, a1, a2, generator,
                        force=forced("single"), **kw)

    def fpm(tensors, m, qs, a1, a2, generator=None, **kw):
        return real_fpm(tensors, m, qs, a1, a2, generator, force=forced("pair"), **kw)

    def sketch(*args):
        *shape, _, like = args
        o = rec["rsvd"].pop(0)
        assert o.shape == tuple(shape), (o.shape, shape)
        return torch.from_numpy(o).to(like.dtype)

    mp.setattr(tbatched, "fused_single_gadget", fsg)
    mp.setattr(tbatched, "fused_pair_measure2", fpm)
    mp.setattr(tlinalg, "_gaussian_sketch", sketch)


def _gkp_cases(mesh, rec):
    out = {"own": _gkp_run(mesh)}
    if rec is not None:
        counts = [GKP_BATCH // mesh.size] * mesh.size
        lo = mesh.rank * counts[0]
        with pytest.MonkeyPatch.context() as mp:
            _replay_sharded(mp, rec, lo, lo + counts[0], GKP_BATCH)
            out["replayed"] = _gkp_run(mesh)
        out["left"] = {k: len(v) for k, v in rec.items() if k != "synd"}
    return out


# ---------------------------------------------------------------------------
# the port: every case of one world, on every rank
# ---------------------------------------------------------------------------

def _gathered(sv):
    """The whole state of a ShardedStateVector, in rank order (= the
    state's order, the first k axes being the rank bits)."""
    return sv.mesh.all_gather(sv.state.reshape(1, -1)).numpy().reshape(-1)


def _port_cases(mesh, gkp_rec, with_qubits):
    out = {}
    if with_qubits:
        k = mesh.size.bit_length() - 1
        qm = qubit_mesh(k, device="cpu")
        out["mesh"] = dict(shape=qm.devices.shape, names=qm.axis_names,
                           ranks=qm.devices.reshape(-1).tolist())

        N, circuit = c_random()
        sv = ShardedStateVector(N, qm)
        for m, t in circuit:
            sv.apply(m, t)
        out["random"] = dict(state=_gathered(sv), block=tuple(sv.state.shape),
                             blocks=mesh.all_gather(torch.tensor([float(
                                 sv.state.abs().sum())])).numpy(),
                             sharding=sv.sharding,
                             amp=complex(sv.amplitude([1, 0, 1, 1, 0, 0, 1, 0, 1, 1])))

        N, circuit = c_layers()
        sv = ShardedStateVector(N, qm).run_circuit(circuit)
        out["layers"] = dict(norm=float(sv.norm()), p0=sv.probabilities(0).numpy(),
                             ez=[float(sv.expectation_z(q)) for q in range(N)],
                             state=_gathered(sv))

        N, circuit = c_ghz()
        sv = ShardedStateVector(N, qm).run_circuit(circuit)
        s = sv.measure(0, torch.Generator().manual_seed(1))
        out["measure"] = dict(s=s, probs=[sv.probabilities(q).numpy() for q in range(1, N)],
                              state=_gathered(sv))

        # a qubit mesh over ranks 0 and 1 only: every rank builds it,
        # the others get None
        sub = qubit_mesh(1, ranks=[0, 1], device="cpu")
        members = mesh.all_gather(torch.tensor([sub is not None])).tolist()
        if sub is not None:
            N, circuit = c_ghz()
            sv = ShardedStateVector(N, sub).run_circuit(circuit)
            out["sub"] = dict(members=members, state=_gathered(sv),
                              ranks=sub.devices.tolist(), rank=sub.rank)

        out["sweep"] = dict(
            coin=sharded_sweep(traj_coin, 13, rng_seed=1, mesh=mesh).numpy(),
            pair=[x.numpy() for x in sharded_sweep(traj_pair, 7, rng_seed=2, mesh=mesh)])
    if gkp_rec is not False:
        out["gkp"] = _gkp_cases(mesh, gkp_rec)
    return out


# ---------------------------------------------------------------------------
# the JAX package on the same gates
# ---------------------------------------------------------------------------

def _jax_cases(D, port):
    import jax
    from quantum_computations_tpu.parallel import ShardedStateVector as JSV, qubit_mesh as jqm

    k = D.bit_length() - 1
    mesh = jqm(k, jax.devices()[:D])
    out = {"mesh": dict(shape=mesh.devices.shape, names=mesh.axis_names)}
    N, circuit = c_random()
    sv = JSV(N, mesh)
    for m, t in circuit:
        sv.apply(m, t)
    out["random"] = dict(state=np.asarray(sv.state).reshape(-1),
                         devices=len(sv.state.sharding.device_set),
                         amp=complex(sv.amplitude([1, 0, 1, 1, 0, 0, 1, 0, 1, 1])))
    N, circuit = c_layers()
    sv = JSV(N, mesh)
    sv.run_circuit(circuit)
    out["layers"] = dict(norm=float(sv.norm()), p0=np.asarray(sv.probabilities(0)),
                         state=np.asarray(sv.state).reshape(-1))
    N, circuit = c_ghz()
    sv = JSV(N, mesh)
    sv.run_circuit(circuit)
    # JAX's measure draws from its key: its collapse onto the port's outcome
    p = np.asarray(sv.probabilities(0))
    s = port["measure"]["s"]
    psi = np.array(sv.state)
    psi[1 - s] = 0.0
    out["measure"] = dict(p=p, state=psi.reshape(-1) / np.sqrt(p[s]))
    return out


def _jax_gkp():
    """JAX's data-sharded run (4 of the 8 virtual devices) with its draws
    and sketches recorded."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import test_torch_batched_gkp as tb
    from quantum_computations_tpu.config import SVDOptions as JOpts
    from quantum_computations_tpu.dv import State as JDV
    from quantum_computations_tpu.gkp.batched import BatchedGKP as JBatched
    from quantum_computations_tpu.gkp.compiled import logical_coeffs as jcoeffs
    from quantum_computations_tpu.parallel import data_mesh as jdm
    from quantum_computations_tpu.pipelines.rb import random_circ as jrc

    circ = jrc(2, 2, np.random.default_rng(123))[1]
    mesh = jdm(jax.devices()[:4])
    with pytest.MonkeyPatch.context() as mp:
        rec = tb._record_jax(mp)
        runner = JBatched(GKP_QS, float(db2eps(10.0)), JOpts(**GKP_OPTS), adaptive=True,
                          granularity="op")
        tensors, frames = runner.run_circuit(
            circ, jcoeffs([JDV.ZERO] * 2), GKP_BATCH, rng_seed=GKP_SEED,
            data_sharding=NamedSharding(mesh, P(mesh.axis_names[0])))
        re, im = runner.readout(tensors, frames)
    rec = {k: list(v) for k, v in rec.items()}
    return dict(frames=np.asarray(frames), rho=np.asarray(re) + 1j * np.asarray(im),
                shapes=[tuple(t.shape) for t in tensors],
                devices=len(tensors[0].sharding.device_set)), rec


@pytest.fixture(scope="module")
def jax_gkp():
    return _jax_gkp()


@pytest.fixture(scope="module")
def serial_gkp():
    return _gkp_run()


@pytest.fixture(scope="module")
def worlds(jax_gkp):
    """One world per D, launched when a test first needs it: the qubit
    cases at D > 1, the data-sharded engine at D in GKP_WORLDS."""
    cache = {}

    def get(D):
        if D not in cache:
            rec = jax_gkp[1] if D in GKP_WORLDS else False
            cache[D] = launch(_port_cases, D, rec, D > 1, device="cpu")
        return cache[D]
    return get


@pytest.fixture(scope="module", params=WORLDS, ids=lambda D: f"D{D}")
def world(request, worlds):
    D = request.param
    port = worlds(D)
    return D, port, _jax_cases(D, port)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the JAX tests' cases
# ---------------------------------------------------------------------------

def test_mesh_construction(world):
    D, port, jax_out = world
    k = D.bit_length() - 1
    assert port["mesh"]["shape"] == jax_out["mesh"]["shape"] == (2,) * k
    assert port["mesh"]["names"] == jax_out["mesh"]["names"] == tuple(
        f"q{i}" for i in range(k))
    assert port["mesh"]["ranks"] == list(range(D))


def test_sharded_matches_dense_random_circuit(world):
    """The sharded N=10 run equals the dense reference and JAX's engine."""
    D, port, jax_out = world
    N, circuit = c_random()
    got = port["random"]
    _close(got["state"], dense_run(N, circuit))
    _close(got["state"], jax_out["random"]["state"])
    _close(got["amp"], jax_out["random"]["amp"])
    # the state is sharded over D ranks: each holds a (2,)*(N-k) block
    k = D.bit_length() - 1
    assert got["block"] == (2,) * (N - k) and len(got["blocks"]) == D
    assert jax_out["random"]["devices"] == D
    assert got["sharding"] == tuple(f"q{i}" for i in range(k)) + (None,) * (N - k)


def test_run_circuit_single_compile(world):
    _, port, jax_out = world
    got = port["layers"]
    assert np.isclose(got["norm"], 1.0, atol=TOL)
    _close(got["p0"], [0.5, 0.5])
    _close(got["p0"], jax_out["layers"]["p0"])
    _close(got["state"], jax_out["layers"]["state"])
    _close(got["ez"], np.zeros(8))


def test_sharded_measurement(world):
    _, port, jax_out = world
    got = port["measure"]
    s = got["s"]
    # after measuring qubit 0, all qubits collapse to the same value
    for p in got["probs"]:
        assert np.isclose(p[s], 1.0, atol=1e-9)
    _close(got["state"], jax_out["measure"]["state"])


def test_batched_sweep():
    out = batched_sweep(traj_square, 100, rng_seed=0)
    assert out.shape == (100,)
    assert 0.5 < float(out.mean()) < 2.0


def test_sharded_sweep_matches_count(world):
    """13 trajectories over D ranks: 13 rows, each the serial sweep's row
    (trajectory i gets one generator whatever D is)."""
    _, port, _ = world
    coin = port["sweep"]["coin"]
    assert coin.shape == (13,)
    np.testing.assert_array_equal(coin, batched_sweep(traj_coin, 13, rng_seed=1).numpy())
    pair = batched_sweep(traj_pair, 7, rng_seed=2)
    for got, want in zip(port["sweep"]["pair"], pair):
        np.testing.assert_array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# beyond the JAX tests
# ---------------------------------------------------------------------------

def test_qubit_mesh_over_some_ranks(world):
    """``ranks=`` picks ranks 0 and 1 of the world (JAX's ``devices=``)."""
    D, port, _ = world
    got = port["sub"]
    assert got["members"] == [True, True] + [False] * (D - 2)
    assert got["ranks"] == [0, 1] and got["rank"] == 0
    N, circuit = c_ghz()
    _close(got["state"], dense_run(N, circuit))


def _fails(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def test_launch_raises_when_one_rank_raises():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(_fails, 2, device="cpu")


def test_mesh_asking_for_cuda_raises():
    """No card here: a mesh or a world on ``cuda`` (the default) raises."""
    for make in (lambda: data_mesh(), lambda: qubit_mesh(0, device="cuda"),
                 lambda: launch(_fails, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_world_of_one_without_a_process_group():
    """No initialised process group: rank 0 of one, no collective."""
    N, circuit = c_random()
    sv = ShardedStateVector(N, qubit_mesh(0, device="cpu")).run_circuit(circuit)
    _close(sv.state.reshape(-1).numpy(), dense_run(N, circuit))
    assert sv.mesh.group is None and sv.mesh.size == 1
    with pytest.raises(ValueError):
        qubit_mesh(1, device="cpu")  # two ranks asked of a world of one


@pytest.mark.parametrize("D", GKP_WORLDS, ids=lambda D: f"D{D}")
def test_data_sharded_run_circuit_equals_serial_and_jax(D, worlds, serial_gkp, jax_gkp):
    out = worlds(D)["gkp"]
    jax_rows, _ = jax_gkp
    own, replayed = out["own"], out["replayed"]
    # the same seed: trajectory for trajectory the serial run
    np.testing.assert_array_equal(own["frames"], serial_gkp["frames"])
    _close(own["rho"], serial_gkp["rho"])
    rows = GKP_BATCH // D
    assert [s[0] for s in own["shapes"]] == [rows] * len(own["shapes"])
    assert [s[1:] for s in own["shapes"]] == [s[1:] for s in serial_gkp["shapes"]]
    assert own["counts"]["fused_single"] == 2 and own["counts"]["bs"] == 2
    # JAX's draws and sketches: JAX's data-sharded rows
    assert out["left"] == {"single": 0, "pair": 0, "rsvd": 0, "stream": 0}
    assert jax_rows["devices"] == 4
    np.testing.assert_array_equal(replayed["frames"], jax_rows["frames"])
    scale = np.abs(jax_rows["rho"]).max()
    _close(replayed["rho"], jax_rows["rho"], TOL * scale)
    assert [s[1:] for s in replayed["shapes"]] == [s[1:] for s in jax_rows["shapes"]]


@pytest.mark.parametrize("decomp", ["rot", "cz"])
def test_batch_shard_draws_the_serial_rows(decomp, monkeypatch):
    """A BatchShard for rows 1..2 of a batch of 4 draws what the serial
    generator draws for them: per-trajectory uniforms, range-finder
    sketches drawn in two passes, and streamed-split sketches (one per
    trajectory along the direct route, three along the three-CZ route)."""
    import quantum_computations_tpu_torch.ops.fused_gadget as tfg
    import quantum_computations_tpu_torch.ops.streamed as tst
    from quantum_computations_tpu_torch.utils.rng import BatchShard

    monkeypatch.setattr(tst, "_BS_DECOMP", decomp)
    B, lo, hi = 4, 1, 3

    def gens():
        return torch.Generator().manual_seed(5), BatchShard(5, B, lo, hi)

    serial, shard = gens()
    _close(tfg._uniforms(hi - lo, shard, "cpu"), tfg._uniforms(B, serial, "cpu")[lo:hi])

    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.normal(size=(B, 12, 9)) + 1j * rng.normal(size=(B, 12, 9)))
    serial, shard = gens()
    want = tlinalg.randomized_range_finder(A, 5, 1, serial)
    got = [tlinalg.randomized_range_finder(A[r:r + 1], 5, 1, shard) for r in (lo, lo + 1)]
    _close(torch.cat(got), want[lo:hi], 1e-12)

    qs = torch.linspace(-6, 6, 12, dtype=torch.float64)
    t1 = torch.from_numpy(rng.normal(size=(B, 2, 12, 2)) + 1j * rng.normal(size=(B, 2, 12, 2)))
    t2 = torch.from_numpy(rng.normal(size=(B, 2, 12, 2)) + 1j * rng.normal(size=(B, 2, 12, 2)))
    kw = dict(max_bond_dim=4, abs_err=0.0, rel_err=1e-12, power_iters=1)
    serial, shard = gens()
    want = tst.streamed_pair_svd_batched(t1, t2, qs, ("rot", np.pi / 4), generator=serial, **kw)
    got = tst.streamed_pair_svd_batched(t1[lo:hi], t2[lo:hi], qs, ("rot", np.pi / 4),
                                        generator=shard, **kw)
    for g, w in zip(got, want):
        _close(g, w[lo:hi], 1e-12)
    # the generators end in the same state: every draw was made
    _close(torch.rand(3, generator=shard), torch.rand(3, generator=serial), 0)
