"""Sequence-search sweep drivers.

Parity with reference ``parallel_optim_search.py`` / ``parallel_full_search.py``:
the memory-sweep with warm-started lower bounds (shared best-so-far keyed by
max memory, :17-21/:52-83) and the fixed-memory (memory x input-rate) full
search (:43-57). The reference uses ``multiprocessing.Pool(3)``; here the
sweep runs either serially (warm starts are then exact, not racy) or over a
process pool (chunk-local warm starts).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ProcessPoolExecutor
from itertools import product

import mpmath
import numpy as np
from mpmath import mpf

mpmath.mp.dps = 80

from .hardware import surface_code_size
from .optimizer import DFSArgs, dfs_code_sequence
from .sequence import GrowStage, InitStage, LogicalDistillationSequence


class SearchSpec:
    """Static search parameters (reference JobStaticArgs)."""

    def __init__(self, in_error, targ_error, code_size_step_size: int, *,
                 no_growing: bool = False, local_error=mpf("0.1e-2"), L_inj: int = 3):
        self.in_error = mpf(in_error)
        self.targ_error = mpf(targ_error)
        targ_L = surface_code_size(local_error, self.targ_error)
        code_sizes = list(range(0, targ_L, code_size_step_size))

        init_seq = LogicalDistillationSequence(InitStage(self.in_error, L_inj, local_error))
        if no_growing:
            init_seq.add_stage(GrowStage(targ_L, init_seq.L, init_seq.p_L, local_error))

        self.dfs_args = DFSArgs(local_error, 0, self.targ_error, targ_L, 0,
                                code_sizes=code_sizes)
        self.init_seq = init_seq


def optim_search_job(memory: int, spec: SearchSpec, warm: tuple | None = None) -> tuple[list[dict], tuple]:
    """One memory point: optimal sequences at input_rate in {0, inf}.

    `warm` is the (seq_rate0, seq_rateinf) pair from a smaller memory point;
    their rates at this memory lower-bound the search (reference job :52-83).
    Returns (result entries, sequences found) for warm-starting the next point.
    """
    warm = warm or (None, None)
    seqs = [None, None]
    input_rates = (0, mpmath.inf)
    for i, input_rate in enumerate(input_rates):
        dfs_args = spec.dfs_args.shallow_copy()
        dfs_args.memory = memory
        dfs_args.input_rate = input_rate
        min_rate = warm[i].distillation_rate(memory, input_rate) if warm[i] else 0.0
        seqs[i] = dfs_code_sequence(dfs_args, spec.init_seq.shallow_copy(), min_rate)

    results = [{
        "memory": int(memory),
        "input_rate": str(input_rate),
        "sequence": seq.serialise() if seq else None,
    } for seq, input_rate in zip(seqs, input_rates)]
    return results, tuple(seqs)


def optim_search(memory_arr, spec: SearchSpec, data_file: str | None = None,
                 progress: bool = True) -> list[dict]:
    """Warm-started memory sweep (serial => exact monotone warm starts)."""
    memory_arr = sorted(int(m) for m in memory_arr)
    iterator = memory_arr
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(memory_arr)
        except ImportError:
            pass
    data = []
    warm = None
    for memory in iterator:
        results, warm = optim_search_job(memory, spec, warm)
        data += results
        if data_file and len(data) % 10 == 0:
            with open(data_file, "w") as fh:
                fh.write(json.dumps(data))
    if data_file:
        with open(data_file, "w") as fh:
            fh.write(json.dumps(data))
    return data


def _full_search_job(args):
    (memory, input_rate), spec, min_rate = args
    dfs_args = spec.dfs_args.shallow_copy()
    dfs_args.memory = memory
    dfs_args.input_rate = input_rate
    seq = dfs_code_sequence(dfs_args, spec.init_seq.shallow_copy(), min_rate)
    return {
        "memory": int(memory),
        "input_rate": str(input_rate),
        "sequence": seq.serialise() if seq else None,
    }


def full_search(memory_arr, rate_arr, spec: SearchSpec, data_file: str | None = None,
                min_rate: float = 7e-3, num_workers: int = 0,
                progress: bool = True) -> list[dict]:
    """Full (memory x input-rate) grid search (reference parallel_full_search)."""
    jobs = [((m, r), spec, min_rate) for m, r in product(memory_arr, rate_arr)]
    if num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            iterator = pool.map(_full_search_job, jobs, chunksize=1)
            data = _collect(iterator, len(jobs), data_file, progress)
    else:
        data = _collect(map(_full_search_job, jobs), len(jobs), data_file, progress)
    if data_file:
        with open(data_file, "w") as fh:
            fh.write(json.dumps(data))
    return data


def _collect(iterator, total, data_file, progress):
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(iterator, total=total)
        except ImportError:
            pass
    data = []
    for result in iterator:
        data.append(result)
        if data_file and len(data) % 10 == 0:
            with open(data_file, "w") as fh:
                fh.write(json.dumps(data))
    return data
