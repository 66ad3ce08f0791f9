"""The port's chain-mode gate kernels against the JAX Pallas kernels.

``apply_1q_plain``, ``apply_2q_adjacent_plain`` and ``apply_1q_chain_plain``
(and the wrappers on CPU tensors, which use them) are held against
``pallas_kernels.apply_1q`` / ``apply_2q_adjacent`` / ``apply_1q_chain``
run in interpret mode, as the JAX package's own tests run them, and
against its XLA reference ``apply_1q_xla``. Tolerance: atol 1e-5 per
amplitude on unnormalised random planes (|x| ~ 1, up to 24 float32 mixes
by unitaries in another order of operations; the JAX package's own kernel
tests use the same).

The CUDA kernels have no CPU mode. What surrounds them is checked here:
``chain_tile``'s bit maps are run through a numpy model of the chain
kernel's index arithmetic (gather, per-gate pair indices, scatter). The
``cuda``-marked tests hold each kernel against its plain version on a CUDA
device and skip without one; on a machine without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_gate_kernels.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quantum_computations_tpu_torch.ops import _build, gate_kernels as gk

ATOL = 1e-5


def _rand_u(rng, d):
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, _ = np.linalg.qr(a)
    return q


def _planes(rng, n):
    return (rng.normal(size=1 << n).astype(np.float32),
            rng.normal(size=1 << n).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.mark.parametrize("N,qubit", [(10, 0), (10, 2), (12, 4)])
def test_apply_1q_plain_matches_pallas_and_xla(N, qubit):
    import jax.numpy as jnp

    from quantum_computations_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(N * 10 + qubit)
    u = _rand_u(rng, 2)
    xr, xi = _planes(rng, N)
    got = gk.apply_1q_plain(*_t(xr, xi), u, qubit, N)
    _close(got, pk.apply_1q(jnp.asarray(xr), jnp.asarray(xi), u, qubit, N,
                            interpret=True))
    _close(got, pk.apply_1q_xla(jnp.asarray(xr), jnp.asarray(xi), u, qubit, N))


@pytest.mark.parametrize("N,qubit", [(10, 0), (12, 3)])
def test_apply_2q_adjacent_plain_matches_pallas(N, qubit):
    import jax.numpy as jnp

    from quantum_computations_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(N * 10 + qubit + 1)
    u = _rand_u(rng, 4)
    xr, xi = _planes(rng, N)
    got = gk.apply_2q_adjacent_plain(*_t(xr, xi), u, qubit, N)
    _close(got, pk.apply_2q_adjacent(jnp.asarray(xr), jnp.asarray(xi), u,
                                     qubit, N, interpret=True))


def _chain_case(kind, rng):
    """(bits, us) at N = 14: distinct bits, or a full 24-gate chain with
    repeats over the planner's bits 7..13."""
    if kind == "distinct":
        bits = (7, 8, 9, 10, 11, 12, 13)
    else:
        bits = tuple(int(b) for b in rng.choice(np.arange(7, 14), 24))
        assert len(set(bits)) < len(bits)
    return bits, np.stack([_rand_u(rng, 2) for _ in bits])


@pytest.mark.parametrize("kind", ["distinct", "repeated24"])
def test_apply_1q_chain_plain_matches_pallas(kind):
    import jax.numpy as jnp

    from quantum_computations_tpu.ops import pallas_kernels as pk

    N = 14
    rng = np.random.default_rng(41 if kind == "distinct" else 43)
    bits, us = _chain_case(kind, rng)
    xr, xi = _planes(rng, N)
    got = gk.apply_1q_chain_plain(*_t(xr, xi), us, bits, N)
    want = pk.apply_1q_chain(jnp.asarray(xr), jnp.asarray(xi),
                             jnp.asarray(us), bits, N, interpret=True)
    _close(got, want)
    _close(gk.apply_1q_chain(*_t(xr, xi), us, bits, N), want)


@pytest.mark.parametrize("c_bits,block_rows", [(11, 32), (11, 4), (9, 8),
                                               (12, 1)])
def test_fusable_bits_equal_jax(c_bits, block_rows):
    from quantum_computations_tpu.ops import pallas_kernels as pk

    for N in range(8, 31):
        assert gk.fusable_bits(N, c_bits, block_rows) == \
            pk.fusable_bits(N, c_bits, block_rows)
    assert gk.fusable_bits(30) == tuple(range(7, 16))
    assert gk._MAX_CHAIN_LEN == pk._MAX_CHAIN_LEN


def _kernel_model(re, im, us, bits, N):
    """The chain kernel's index arithmetic in numpy: each block gathers its
    tile through ``chain_tile``'s maps, applies the gates to tile-local
    pairs, and scatters the tile back. Also returns how often each
    amplitude was owned."""
    low, high, other, local = gk.chain_tile(bits, N)
    T = low + len(high)
    re, im = re.astype(np.float64), im.astype(np.float64)
    owned = np.zeros(1 << N, int)
    lane = np.arange(1 << T)
    p = np.arange(1 << (T - 1))
    for blk in range(1 << len(other)):
        base = 0
        for j, o in enumerate(other):
            base |= ((blk >> j) & 1) << o
        off = base | (lane & ((1 << low) - 1))
        for j, h in enumerate(high):
            off |= ((lane >> (low + j)) & 1) << h
        owned[off] += 1
        x = re[off] + 1j * im[off]
        for u, lb in zip(us, local):
            i0 = ((p >> lb) << (lb + 1)) | (p & ((1 << lb) - 1))
            i1 = i0 | (1 << lb)
            a, b = x[i0], x[i1]
            x[i0], x[i1] = u[0, 0] * a + u[0, 1] * b, u[1, 0] * a + u[1, 1] * b
        re[off], im[off] = x.real, x.imag
    return re, im, owned


@pytest.mark.parametrize("N,bits", [
    (14, (7, 8, 9, 10, 11, 12, 13) * 3),
    (16, (15, 0, 3, 15, 9)),
    (20, tuple(range(7, 16)) * 2 + (7, 8, 9, 10, 11, 12)),
    (13, tuple(range(13))),
    (5, (0, 4, 2)),
])
def test_chain_tile_model_matches_plain(N, bits):
    rng = np.random.default_rng(N)
    us = np.stack([_rand_u(rng, 2) for _ in bits])
    xr, xi = _planes(rng, N)
    got_r, got_i, owned = _kernel_model(xr, xi, us, bits, N)
    assert np.all(owned == 1)  # every amplitude in exactly one block
    want = gk.apply_1q_chain_plain(*_t(xr, xi), us, bits, N)
    np.testing.assert_allclose(got_r, want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(got_i, want[1].numpy(), atol=ATOL)
    low, high, other, local = gk.chain_tile(bits, N)
    assert low + len(high) == min(gk.CHAIN_TILE_BITS, N)
    assert sorted(list(range(low)) + high + other) == list(range(N))


def test_chain_tile_at_full_width():
    """N = 30, the planner's bits 7..15: tile = bits 0..3 and 7..15."""
    low, high, other, local = gk.chain_tile(tuple(range(15, 6, -1)), 30)
    assert (low, high) == (4, list(range(7, 16)))
    assert other == [4, 5, 6] + list(range(16, 30))
    assert local == list(range(12, 3, -1))


def _compose_case(kind, rng):
    """(bits, us) at N = 14: the "distinct" and "repeated24" chains, and a
    chain that comes back to bits after gates on other bits."""
    if kind != "revisit":
        return _chain_case(kind, rng)
    bits = (7, 9, 7, 13, 9, 8, 7, 13, 12, 9)
    return bits, np.stack([_rand_u(rng, 2) for _ in bits])


@pytest.mark.parametrize("kind", ["distinct", "repeated24", "revisit"])
def test_compose_chain_matches_plain_and_pallas(kind):
    """The per-bit composition the kernel applies, one mix per distinct
    bit, equals the chain gate by gate: the plain version and the JAX
    Pallas kernel (interpret mode)."""
    import jax.numpy as jnp

    from quantum_computations_tpu.ops import pallas_kernels as pk

    N = 14
    rng = np.random.default_rng({"distinct": 61, "repeated24": 67,
                                 "revisit": 71}[kind])
    bits, us = _compose_case(kind, rng)
    distinct, mixes = gk.compose_chain(us, bits)
    assert distinct == tuple(dict.fromkeys(bits))
    assert mixes.shape == (len(distinct), 2, 2)
    np.testing.assert_allclose(mixes @ mixes.conj().transpose(0, 2, 1),
                               np.broadcast_to(np.eye(2), mixes.shape),
                               atol=1e-12)
    xr, xi = _planes(rng, N)
    got = _t(xr, xi)
    for m, b in zip(mixes, distinct):
        got = gk.apply_1q_plain(*got, m, N - b - 1, N)
    _close(got, gk.apply_1q_chain_plain(*_t(xr, xi), us, bits, N))
    _close(got, pk.apply_1q_chain(jnp.asarray(xr), jnp.asarray(xi),
                                  jnp.asarray(us), bits, N, interpret=True))


def _planned_kernel_model(re, im, us, bits, N):
    """The chain kernel in numpy, from the tables ``apply_1q_chain`` hands
    it: per block, each thread gathers its registers through the first
    stage's offsets, applies its stage's mixes, goes through the swizzled
    shared tile to the next stage's layout, and stores through the last
    stage's offsets. Asserts that each stage's shared slots, and each
    block's loads and stores, are one permutation of the tile."""
    distinct, mixes = gk.compose_chain(us, bits)
    plan = gk.chain_plan(distinct, N)
    rb, tb = plan["reg_bits"], plan["thread_bits"]
    tid = np.arange(1 << tb)
    stage_mixes = [dict() for _ in plan["regs"]]
    for m, (stage, slot) in zip(mixes.astype(np.complex64), plan["mix_slot"]):
        stage_mixes[stage][slot] = m

    def part(pos):
        return sum((((tid >> j) & 1) << p for j, p in enumerate(pos)),
                   np.zeros_like(tid))

    def mix(x, s):
        x = x.reshape((1 << tb,) + (2,) * rb)
        for q, m in stage_mixes[s].items():
            x = np.moveaxis(np.tensordot(m, x, axes=([1], [rb - q])), 0, rb - q)
        return x.reshape(1 << tb, 1 << rb)

    swz = np.vectorize(gk._swizzle)
    x = (re.astype(np.float64) + 1j * im).copy()
    out = x.copy()
    owned = np.zeros(1 << N, int)
    for blk in range(1 << len(plan["other"])):
        base = sum(((blk >> j) & 1) << o for j, o in enumerate(plan["other"]))
        load = base + part(plan["gthr"][0])[:, None] + \
            np.array(plan["greg"][0])[None, :]
        owned[load] += 1
        regs = mix(x[load], 0)
        for s in range(1, len(plan["regs"])):
            slots = swz(part(plan["sthr"][s - 1]))[:, None] ^ \
                np.array(plan["sreg"][s - 1])[None, :]
            assert sorted(slots.ravel()) == list(range(1 << (tb + rb)))
            tile = np.empty(1 << (tb + rb), complex)
            tile[slots] = regs
            slots = swz(part(plan["sthr"][s]))[:, None] ^ \
                np.array(plan["sreg"][s])[None, :]
            regs = mix(tile[slots], s)
        store = base + part(plan["gthr"][1])[:, None] + \
            np.array(plan["greg"][1])[None, :]
        assert sorted(store.ravel()) == sorted(load.ravel())
        out[store] = regs
    return out.real, out.imag, owned


@pytest.mark.parametrize("N,bits", [
    (14, (7, 8, 9, 10, 11, 12, 13) * 3),
    (16, (15, 0, 3, 15, 9)),
    (20, tuple(range(15, 6, -1)) * 2 + (7, 8, 9, 10, 11, 12)),
    (13, tuple(range(13))),
    (12, tuple(range(12)) * 2),
    (5, (0, 4, 2)),
    (3, (0, 2, 1, 2)),
])
def test_chain_plan_model_matches_plain(N, bits):
    """The register-resident kernel's tables, run through a numpy model of
    its index arithmetic, give the plain chain; every amplitude is owned by
    exactly one block."""
    rng = np.random.default_rng(N + 100)
    us = np.stack([_rand_u(rng, 2) for _ in bits])
    xr, xi = _planes(rng, N)
    got_r, got_i, owned = _planned_kernel_model(xr, xi, us, bits, N)
    assert np.all(owned == 1)
    want = gk.apply_1q_chain_plain(*_t(xr, xi), us, bits, N)
    np.testing.assert_allclose(got_r, want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(got_i, want[1].numpy(), atol=ATOL)
    plan = gk.chain_plan(tuple(dict.fromkeys(bits)), N)
    assert len(plan["regs"]) == -(-len(set(bits)) // plan["reg_bits"])


def test_chain_plan_at_full_width():
    """N = 30, the planner's bits 7..15 (tile bits 4..12): two stages, one
    shared round trip; the lanes of a warp cover runs of 16 amplitudes in
    device memory and 32 banks of shared memory in both layouts."""
    plan = gk.chain_plan(tuple(range(15, 6, -1)), 30)
    assert plan["regs"] == [[12, 11, 10, 9, 8], [7, 6, 5, 4, 12]]
    assert (plan["reg_bits"], plan["thread_bits"]) == (5, 8)
    for gthr in plan["gthr"]:
        assert gthr[:4] == [0, 1, 2, 3]  # lanes 0..15: 64 contiguous bytes
    lane = np.arange(32)
    for sthr, sreg in zip(plan["sthr"], plan["sreg"]):
        for warp in range(8):
            tid = warp * 32 + lane
            st = [gk._swizzle(sum(((t >> j) & 1) << p
                                  for j, p in enumerate(sthr))) for t in tid]
            for r in sreg:
                assert len({(s ^ r) % 32 for s in st}) == 32


@pytest.mark.parametrize("which", ["1q", "2q", "chain"])
def test_wrappers_on_cpu_use_plain_and_count_no_launch(which):
    rng = np.random.default_rng(7)
    N = 9
    xr, xi = _t(*_planes(rng, N))
    if which == "1q":
        args, wrap, plain = (_rand_u(rng, 2), 3, N), gk.apply_1q, \
            gk.apply_1q_plain
    elif which == "2q":
        args, wrap, plain = (_rand_u(rng, 4), 5, N), gk.apply_2q_adjacent, \
            gk.apply_2q_adjacent_plain
    else:
        us = np.stack([_rand_u(rng, 2) for _ in range(4)])
        args, wrap, plain = (us, (0, 8, 0, 4), N), gk.apply_1q_chain, \
            gk.apply_1q_chain_plain
    before = wrap.launches
    got = wrap(xr, xi, *args)
    want = plain(xr, xi, *args)
    assert wrap.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_BAD = ["dtype", "plane_size", "noncontiguous", "device", "plane_mismatch",
        "gate_shape", "qubit", "gate_on_device"]


def _bad_inputs(bad, span):
    rng = np.random.default_rng(3)
    N = 8
    xr, xi = _t(*_planes(rng, N))
    u = _rand_u(rng, 1 << span)
    qubit = 2
    if bad == "dtype":
        xr = xr.double()
    elif bad == "plane_size":
        xr, xi = xr[:-1].contiguous(), xi[:-1].contiguous()
    elif bad == "noncontiguous":
        xr = torch.stack([xr, xr], 1)[:, 0]
    elif bad == "device":
        xr, xi = xr.to("meta"), xi.to("meta")
    elif bad == "plane_mismatch":
        xi = xi.reshape(16, 16)
    elif bad == "gate_shape":
        u = u[:, :1]
    elif bad == "qubit":
        qubit = N - span + 1
    elif bad == "gate_on_device":
        u = torch.from_numpy(u).to("meta")
    return xr, xi, u, qubit, N


@pytest.mark.parametrize("bad", _BAD)
@pytest.mark.parametrize("which", ["1q", "2q"])
def test_gate_wrappers_reject_bad_inputs(which, bad):
    span = 1 if which == "1q" else 2
    fn = gk.apply_1q if which == "1q" else gk.apply_2q_adjacent
    with pytest.raises((ValueError, TypeError)):
        fn(*_bad_inputs(bad, span))


@pytest.mark.parametrize("bad", ["bit_out_of_range", "negative_bit",
                                 "too_many_distinct", "too_long",
                                 "bits_len_mismatch", "empty", "dtype",
                                 "device"])
def test_chain_wrapper_rejects_bad_inputs(bad):
    rng = np.random.default_rng(5)
    N = 16
    xr, xi = _t(*_planes(rng, N))
    bits = [7, 8, 7]
    if bad == "bit_out_of_range":
        bits = [7, N]
    elif bad == "negative_bit":
        bits = [-1]
    elif bad == "too_many_distinct":
        bits = list(range(gk.CHAIN_TILE_BITS + 1))
    elif bad == "too_long":
        bits = [7, 8] * 13
    elif bad == "empty":
        bits = []
    us = np.stack([_rand_u(rng, 2) for _ in bits]) if bits else \
        np.zeros((0, 2, 2))
    if bad == "bits_len_mismatch":
        us = us[:2]
    elif bad == "dtype":
        xr = xr.double()
    elif bad == "device":
        xr, xi = xr.to("meta"), xi.to("meta")
    with pytest.raises((ValueError, TypeError)):
        gk.apply_1q_chain(xr, xi, us, bits, N)


def test_gate_kernels_import_without_nvcc_or_cuda():
    """The module imports, and its CPU path runs, with no nvcc and no CUDA:
    the kernels are built at the first launch on a CUDA tensor."""
    code = ("import numpy as np, torch\n"
            "from quantum_computations_tpu_torch.ops import gate_kernels as g\n"
            "x = torch.ones(1 << 8)\n"
            "g.apply_1q(x, x.clone(), np.eye(2), 0, 8)\n"
            "g.apply_2q_adjacent(x, x.clone(), np.eye(4), 0, 8)\n"
            "g.apply_1q_chain(x, x.clone(), np.eye(2)[None], (7,), 8)\n"
            "assert g.apply_1q.launches == g.apply_1q_chain.launches == 0\n")
    env = dict(os.environ, PATH="", CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


def test_library_paths_of_gate_sources():
    for name in ("gate_mix", "chain_mix"):
        p = _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}-")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _on_card_vs_plain(wrap, plain, xr, xi, *args):
    xr, xi = xr.cuda(), xi.cuda()
    want = plain(xr, xi, *args)
    ptrs = (xr.data_ptr(), xi.data_ptr())
    before = wrap.launches
    got = wrap(xr, xi, *args)
    torch.cuda.synchronize()
    assert (got[0].data_ptr(), got[1].data_ptr()) == ptrs  # in place
    assert wrap.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, 2])
def test_gate_kernels_match_plain_on_card(span):
    _card()
    rng = np.random.default_rng(span)
    wrap = gk.apply_1q if span == 1 else gk.apply_2q_adjacent
    plain = gk.apply_1q_plain if span == 1 else gk.apply_2q_adjacent_plain
    for N in (span, 5, 12, 20):
        for qubit in sorted({0, min(N // 2, N - span), N - span}):
            xr, xi = _t(*_planes(rng, N))
            _on_card_vs_plain(wrap, plain, xr, xi, _rand_u(rng, 2 ** span),
                              qubit, N)
            # an offset view: 4-byte aligned only, the scalar path
            big_r, big_i = _t(*_planes(rng, N + 1))
            _on_card_vs_plain(wrap, plain, big_r[1:1 + (1 << N)],
                              big_i[1:1 + (1 << N)], _rand_u(rng, 2 ** span),
                              qubit, N)


@pytest.mark.cuda
@pytest.mark.parametrize("N,bits", [
    (12, (7,)), (12, tuple(range(12)) * 2), (14, (7, 8, 9, 10, 11, 12, 13) * 3),
    (20, tuple(range(15, 6, -1)) * 2 + (7, 9, 11, 13, 15, 8)),
    (20, (0, 19, 5, 0, 12)), (3, (0, 2, 1, 2)),
])
def test_chain_kernel_matches_plain_on_card(N, bits):
    _card()
    rng = np.random.default_rng(N + len(bits))
    us = np.stack([_rand_u(rng, 2) for _ in bits])
    xr, xi = _t(*_planes(rng, N))
    _on_card_vs_plain(gk.apply_1q_chain, gk.apply_1q_chain_plain, xr, xi, us,
                      bits, N)
