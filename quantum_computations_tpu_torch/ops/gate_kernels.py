"""Gate kernels of the port's chain mode: counterpart of the per-gate half of
``quantum_computations_tpu/ops/pallas_kernels.py``.

Three wrapper/plain pairs over split-real float32 planes of length 2^N:

- :func:`apply_1q` — a 2x2 complex mix of one qubit (``csrc/gate_mix.cu``);
- :func:`apply_2q_adjacent` — a 4x4 complex mix of the pair (q, q+1)
  (``csrc/gate_mix.cu``);
- :func:`apply_1q_chain` — up to 24 single-qubit mixes on AMPLITUDE bits in
  one pass over the state (``csrc/chain_mix.cu``): the wrapper composes
  them per bit (:func:`compose_chain`) and the kernel applies one mix per
  distinct bit, with the amplitudes in registers (:func:`chain_plan`).

Qubits are big-endian (qubit q is amplitude bit N - q - 1); the chain takes
amplitude bits (LSB = 0), as the JAX kernel does. On CUDA tensors each
wrapper launches its Hopper kernel, updates the planes in place and returns
the same tensors; on CPU tensors it returns its plain version's new tensors.
Any other device raises. Gate matrices are host data (numpy or CPU tensors):
they travel to the kernel by value, in its parameter block.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ..config import full_fp32_matmul

__all__ = ["apply_1q", "apply_1q_plain", "apply_2q_adjacent",
           "apply_2q_adjacent_plain", "apply_1q_chain",
           "apply_1q_chain_plain", "fusable_bits", "chain_tile",
           "compose_chain", "chain_plan"]

_LANE_MIN_BITS = 7   # the planner's rule, copied from the JAX package
_MAX_CHAIN_LEN = 24  # gates in one chain (the kernel's parameter block)
CHAIN_TILE_BITS = 13  # amplitudes per plane in one chain tile: 2^13 (32 KiB)
CHAIN_REG_BITS = 5   # amplitudes per plane a chain thread holds: 2^5
_MAX_STAGES = 3      # ceil(CHAIN_TILE_BITS / CHAIN_REG_BITS) register stages


def fusable_bits(num_qubits: int, c_bits: int = 11, block_rows: int = 32):
    """Amplitude-bit positions the chain planner fuses, for the JAX
    package's (c_bits, block_rows) layout. This is the PLANNER's rule, kept
    so both engines plan the same chains; the kernel holds any bits
    (:func:`chain_tile`)."""
    hi = min(num_qubits, c_bits + int(np.log2(block_rows)))
    return tuple(range(_LANE_MIN_BITS, min(c_bits, num_qubits))) + \
        tuple(range(c_bits, hi))


def chain_tile(bits, num_qubits: int):
    """The chain kernel's tile for amplitude ``bits``.

    The tile holds the distinct chain bits plus the lowest other bits, up
    to ``min(CHAIN_TILE_BITS, N)`` bits; one block owns one value of every
    bit outside it. Returns ``(low, high, other, local)``: tile bits
    ``0..low-1`` are amplitude bits ``0..low-1`` (contiguous runs for
    coalesced access), tile bit ``low + j`` is amplitude bit ``high[j]``,
    ``other`` lists the amplitude bits the block index spans (LSB first),
    and ``local[g]`` is gate g's bit inside the tile. Raises if the chain
    has more distinct bits than a tile holds.
    """
    N = int(num_qubits)
    distinct = set(bits)
    if not all(0 <= b < N for b in distinct):
        raise ValueError(f"chain bits {sorted(distinct)} out of range for "
                         f"N={N}")
    size = min(CHAIN_TILE_BITS, N)
    if len(distinct) > size:
        raise ValueError(f"the chain kernel holds at most {size} distinct "
                         f"bits at N={N}, got {len(distinct)}")
    tile = set(distinct)
    for b in range(N):
        if len(tile) == size:
            break
        tile.add(b)
    tile = sorted(tile)
    low = 0
    while low < size and tile[low] == low:
        low += 1
    pos = {b: i for i, b in enumerate(tile)}
    other = [b for b in range(N) if b not in pos]
    return low, tile[low:], other, [pos[b] for b in bits]


def compose_chain(us, bits):
    """Compose a chain per bit: single-qubit gates on different bits
    commute, and gates on one bit compose in chain order (a later gate on
    the left), in float64 on the host. Returns ``(distinct, mixes)``: the
    distinct bits in order of first appearance and their (m, 2, 2)
    complex128 products."""
    distinct = tuple(dict.fromkeys(int(b) for b in bits))
    mats = {b: np.eye(2, dtype=np.complex128) for b in distinct}
    for u, b in zip(us, bits):
        mats[int(b)] = np.asarray(u, np.complex128) @ mats[int(b)]
    return distinct, np.stack([mats[b] for b in distinct])


def _swizzle(local: int) -> int:
    """Shared-memory slot of tile index ``local``: bit 4 flipped by the
    parity of bits 5 and up, so that the 32 lanes of a warp hit 32 banks
    when they span tile bits 0..3 and any one higher bit. It is linear
    over XOR, so a thread's part and a register's part swizzle apart."""
    return local ^ ((bin(local >> 5).count("1") & 1) << 4)


def chain_plan(bits: tuple, num_qubits: int) -> dict:
    """The chain kernel's tables for DISTINCT amplitude ``bits`` (each
    with one composed mix, in this order).

    The tile is :func:`chain_tile`'s. A thread holds 2^rb amplitudes of
    each plane, rb = min(CHAIN_REG_BITS, tile bits): its register index
    spans rb tile bits, its thread index the others (ascending, so that
    the lanes span the lowest, contiguous ones). Stage s puts the tile bits
    ``regs[s]`` in registers and applies the mixes of the chain bits among
    them; the highest chain bits go first, and a stage with fewer chain
    bits than rb is padded with the highest other tile bits. The first
    stage loads from device memory, the last stores, and between two
    stages the tile goes once through shared memory.

    Returns the kernel's tables: ``regs``, ``mix_slot`` (stage and
    register slot of each bit's mix), ``greg``/``gthr`` (the amplitude
    offset of each register index, and the amplitude bit of each thread
    bit, for the first and last stage), ``sreg``/``sthr`` (the swizzled
    tile offset of each register index, and the tile bit of each thread
    bit, per stage), ``other``, ``tile_bits``, ``reg_bits`` and
    ``thread_bits``.
    """
    N = int(num_qubits)
    if len(set(bits)) != len(bits):
        raise ValueError(f"chain_plan takes distinct bits, got {bits}")
    low, high, other, local = chain_tile(bits, N)
    T = low + len(high)
    amp = list(range(low)) + list(high)  # tile bit -> amplitude bit
    rb = min(CHAIN_REG_BITS, T)
    todo = sorted(local, reverse=True)
    regs, mix_slot = [], {}
    while todo:
        chosen, todo = todo[:rb], todo[rb:]
        pad = [b for b in range(T - 1, -1, -1) if b not in chosen]
        regs.append(chosen + pad[:rb - len(chosen)])
        for slot, b in enumerate(chosen):
            mix_slot[b] = (len(regs) - 1, slot)
    threads = [[b for b in range(T) if b not in r] for r in regs]

    def offsets(r, weight):
        return [sum(weight(r[p]) for p in range(rb) if i >> p & 1)
                for i in range(1 << rb)]

    return dict(
        regs=regs, mix_slot=[mix_slot[b] for b in local], other=other,
        tile_bits=T, reg_bits=rb, thread_bits=T - rb,
        greg=[offsets(regs[s], lambda b: 1 << amp[b]) for s in (0, -1)],
        gthr=[[amp[b] for b in threads[s]] for s in (0, -1)],
        sreg=[[_swizzle(o) for o in offsets(r, lambda b: 1 << b)]
              for r in regs],
        sthr=threads)


# -- checks ----------------------------------------------------------------
def _gates(u, shape: tuple) -> np.ndarray:
    """Host complex64 copy of gate matrices ``u`` of ``shape``."""
    if isinstance(u, torch.Tensor):
        if u.device.type != "cpu":
            raise ValueError("gate matrices are host data (numpy or CPU "
                             f"tensors), got a tensor on {u.device}")
        u = u.resolve_conj().numpy()
    u = np.asarray(u).astype(np.complex64)
    if u.shape != shape:
        raise ValueError(f"gate matrices must have shape {shape}, got "
                         f"{u.shape}")
    return u


def _check_planes(re: torch.Tensor, im: torch.Tensor, num_qubits: int):
    for name, t in (("re", re), ("im", im)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() != 1 << num_qubits or t.dim() != 1:
            raise ValueError(f"{name} must be a flat plane of 2**{num_qubits}"
                             f" values, got shape {tuple(t.shape)}")
    if re.device != im.device:
        raise ValueError(f"im is on {im.device}, re on {re.device}")


def _check_qubit(qubit: int, num_qubits: int, span: int):
    if not 0 <= qubit <= num_qubits - span:
        raise ValueError(f"qubit {qubit} (span {span}) out of range for "
                         f"N={num_qubits}")


def _route(name: str, re: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA), False for the plain version (CPU)."""
    if re.device.type == "cpu":
        return False
    if re.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {re.device}")
    return True


def _floats(*arrays) -> ctypes.Array:
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    return (ctypes.c_float * flat.size)(*flat.tolist())


def _ints(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * max(1, len(values)))(*values)


def _launch(fn, re: torch.Tensor, *args):
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        return fn(*args, stream)


def _raise_on(err: int, name: str, **shape):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({shape})")


@functools.cache
def _gate_mix():
    lib = _build.load("gate_mix")
    for fn in (lib.qct_apply_1q, lib.qct_apply_2q_adjacent):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _chain_mix():
    fn = _build.load("chain_mix").qct_apply_1q_chain
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _padded(rows, width: int, n_rows: int, ctype=ctypes.c_int):
    """``rows`` as one flat C array of ``n_rows`` rows of ``width``,
    zero-padded: the kernel's parameter block has fixed-size tables."""
    flat = [0] * (width * n_rows)
    for i, row in enumerate(rows):
        flat[i * width:i * width + len(row)] = [int(v) for v in row]
    return (ctype * len(flat))(*flat)


@functools.lru_cache(maxsize=256)
def _chain_tables(bits: tuple, num_qubits: int):
    """``chain_plan``'s integer tables as the C arrays the kernel takes."""
    plan = chain_plan(bits, num_qubits)
    regs, thr = 1 << CHAIN_REG_BITS, CHAIN_TILE_BITS - CHAIN_REG_BITS
    return (plan,
            _padded(plan["greg"], regs, 2, ctypes.c_longlong),
            _padded(plan["sreg"], regs, _MAX_STAGES),
            _padded(plan["gthr"], thr, 2),
            _padded(plan["sthr"], thr, _MAX_STAGES),
            _ints(plan["other"]))


# -- apply_1q --------------------------------------------------------------
def apply_1q_plain(re: torch.Tensor, im: torch.Tensor, u, qubit: int,
                   num_qubits: int):
    """``x <- u x`` on ``qubit`` over the (2^q, 2, 2^(N-q-1)) view, out of
    place, in full FP32 (the JAX package's ``apply_1q_xla``)."""
    return _mix_plain(re, im, _gates(u, (2, 2)), qubit, num_qubits, 1)


def apply_1q(re: torch.Tensor, im: torch.Tensor, u, qubit: int,
             num_qubits: int):
    """Apply a single-qubit unitary ``u`` (2, 2) to big-endian ``qubit``.

    CUDA: the Hopper kernel, in place, any qubit (the TPU's inner >= 128
    rule is a lane rule the GPU does not have). CPU: :func:`apply_1q_plain`.
    """
    g = _gates(u, (2, 2))
    _check_planes(re, im, num_qubits)
    _check_qubit(qubit, num_qubits, 1)
    if not _route("apply_1q", re):
        return _mix_plain(re, im, g, qubit, num_qubits, 1)
    err = _launch(_gate_mix().qct_apply_1q, re, re.data_ptr(), im.data_ptr(),
                  _floats(g.real, g.imag), qubit, num_qubits)
    _raise_on(err, "apply_1q", qubit=qubit, num_qubits=num_qubits)
    apply_1q.launches += 1
    return re, im


apply_1q.launches = 0  # kernel launches, counted where they happen


# -- apply_2q_adjacent -------------------------------------------------------
def apply_2q_adjacent_plain(re: torch.Tensor, im: torch.Tensor, u,
                            qubit: int, num_qubits: int):
    """``x <- u x`` on the pair (qubit, qubit+1), row/column index
    2 b_qubit + b_{qubit+1}, over the (2^q, 4, 2^(N-q-2)) view, out of
    place, in full FP32."""
    return _mix_plain(re, im, _gates(u, (4, 4)), qubit, num_qubits, 2)


def apply_2q_adjacent(re: torch.Tensor, im: torch.Tensor, u, qubit: int,
                      num_qubits: int):
    """Apply a two-qubit unitary ``u`` (4, 4) to the ADJACENT pair
    (qubit, qubit+1). CUDA: the Hopper kernel, in place, any pair. CPU:
    :func:`apply_2q_adjacent_plain`."""
    g = _gates(u, (4, 4))
    _check_planes(re, im, num_qubits)
    _check_qubit(qubit, num_qubits, 2)
    if not _route("apply_2q_adjacent", re):
        return _mix_plain(re, im, g, qubit, num_qubits, 2)
    err = _launch(_gate_mix().qct_apply_2q_adjacent, re, re.data_ptr(),
                  im.data_ptr(), _floats(g.real, g.imag), qubit, num_qubits)
    _raise_on(err, "apply_2q_adjacent", qubit=qubit, num_qubits=num_qubits)
    apply_2q_adjacent.launches += 1
    return re, im


apply_2q_adjacent.launches = 0


def _mix_plain(re, im, g: np.ndarray, qubit: int, num_qubits: int,
               span: int):
    _check_planes(re, im, num_qubits)
    _check_qubit(qubit, num_qubits, span)
    shape = (1 << qubit, 1 << span, 1 << (num_qubits - qubit - span))
    xr = re.reshape(shape)
    xi = im.reshape(shape)
    ur = torch.from_numpy(np.ascontiguousarray(g.real)).to(re.device)
    ui = torch.from_numpy(np.ascontiguousarray(g.imag)).to(re.device)
    with full_fp32_matmul():
        out_r = (torch.einsum("bc,acj->abj", ur, xr)
                 - torch.einsum("bc,acj->abj", ui, xi))
        out_i = (torch.einsum("bc,acj->abj", ur, xi)
                 + torch.einsum("bc,acj->abj", ui, xr))
    return out_r.reshape(-1), out_i.reshape(-1)


# -- apply_1q_chain ----------------------------------------------------------
def _chain_gates(us, bits) -> tuple[np.ndarray, tuple[int, ...]]:
    bits = tuple(int(b) for b in bits)
    g = _gates(us, (len(bits), 2, 2))
    if not bits:
        raise ValueError("a chain needs at least one gate")
    return g, bits


def apply_1q_chain_plain(re: torch.Tensor, im: torch.Tensor, us, bits,
                         num_qubits: int):
    """The chain as ``len(bits)`` sequential :func:`apply_1q_plain` calls,
    gate g on amplitude bit ``bits[g]`` (qubit N - bits[g] - 1)."""
    g, bits = _chain_gates(us, bits)
    for u, b in zip(g, bits):
        if not 0 <= b < num_qubits:
            raise ValueError(f"chain bit {b} out of range for N={num_qubits}")
        re, im = _mix_plain(re, im, u, num_qubits - b - 1, num_qubits, 1)
    return re, im


def apply_1q_chain(re: torch.Tensor, im: torch.Tensor, us, bits,
                   num_qubits: int):
    """Apply single-qubit unitaries ``us`` (k, 2, 2) on amplitude ``bits``
    (LSB = 0; repeats allowed; applied in chain order) in ONE pass.

    At most 24 gates, on at most ``min(CHAIN_TILE_BITS, N)`` distinct bits
    (:func:`chain_tile`); any bit position. CUDA: the gates composed per bit
    (:func:`compose_chain`), then the Hopper kernel, in place. CPU:
    :func:`apply_1q_chain_plain`.
    """
    g, bits = _chain_gates(us, bits)
    _check_planes(re, im, num_qubits)
    if len(bits) > _MAX_CHAIN_LEN:
        raise ValueError(f"a chain holds at most {_MAX_CHAIN_LEN} gates, got "
                         f"{len(bits)}")
    chain_tile(bits, num_qubits)  # the bits the kernel holds, either route
    if not _route("apply_1q_chain", re):
        return apply_1q_chain_plain(re, im, g, bits, num_qubits)
    distinct, mixes = compose_chain(g, bits)
    plan, greg, sreg, gthr, sthr, other = _chain_tables(distinct, num_qubits)
    mix = np.zeros((_MAX_STAGES, CHAIN_REG_BITS, 8), np.float32)
    mask = [0] * _MAX_STAGES
    for m, (stage, slot) in zip(mixes, plan["mix_slot"]):
        mix[stage, slot] = np.concatenate([m.real.ravel(), m.imag.ravel()])
        mask[stage] |= 1 << slot
    err = _launch(_chain_mix(), re, re.data_ptr(), im.data_ptr(),
                  _floats(mix), greg, sreg, gthr, sthr, _ints(mask),
                  len(plan["regs"]), plan["reg_bits"], plan["thread_bits"],
                  other, len(plan["other"]))
    _raise_on(err, "apply_1q_chain", bits=bits, num_qubits=num_qubits)
    apply_1q_chain.launches += 1
    return re, im


apply_1q_chain.launches = 0
