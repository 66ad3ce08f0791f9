"""Shared pipeline infrastructure (counterpart of
``quantum_computations_tpu/pipelines/common.py``): dataclass configs with a
CLI, the whole-file JSON ``.dat`` output the reference's analysis reads,
and the engine threads of the batched pipelines (:func:`run_engines`).
The JAX package's persistent compile cache has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import threading

import torch

from ..ops import herm_eigh_small


def write_data(path: str, data: list[dict]):
    """Whole-file JSON rewrite. ``default=float`` writes numpy scalars."""
    with open(path, "w") as fh:
        fh.write(json.dumps(data, default=float))


def prepare_output(path: str, overwrite: bool = False):
    if path is None:
        return
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"File {path} already exists!")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    open(path, "w").close()


def config_cli(config_cls, argv=None):
    """Build an argparse CLI from a dataclass config and parse argv; also
    turns on INFO logging (the per-cell progress lines of a sweep)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s", datefmt="%H:%M:%S")
    parser = argparse.ArgumentParser(description=config_cls.__doc__)
    for f in dataclasses.fields(config_cls):
        arg = "--" + f.name.replace("_", "-")
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        if f.type in ("bool", bool):
            parser.add_argument(arg, action="store_true" if not default else "store_false")
        elif f.type in ("int", int):
            parser.add_argument(arg, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(arg, type=float, default=default)
        else:
            parser.add_argument(arg, type=str, default=default)
    ns = parser.parse_args(argv)
    return config_cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(config_cls)})


def run_engines(work, runners, errors: list) -> None:
    """``work(runner)`` in one Python thread per engine, each on a CUDA
    stream of its own (PyTorch's current stream is thread-local; on the
    CPU no stream is made), so one engine's dispatches go on while
    another waits on a fetch. A worker's exception is appended to
    ``errors``, which ``work`` reads to stop early, and the first is
    raised once every thread has joined."""
    def body(runner):
        try:
            stream = (torch.cuda.stream(torch.cuda.Stream(runner.device))
                      if runner.device.type == "cuda" else contextlib.nullcontext())
            with stream:
                work(runner)
        except Exception as exc:  # raised in the caller's thread after join
            errors.append(exc)

    cuda = [r.device for r in runners if r.device.type == "cuda"]
    if cuda:
        # torch loads its CUDA linear-algebra library lazily, and the loader
        # fails ("lazy wrapper should be called at most once") when several
        # threads make their first calls together: load it from this thread,
        # and the split's eigensolver kernel with it
        torch.linalg.eigh(torch.eye(2, dtype=torch.complex128, device=cuda[0]))
        herm_eigh_small.load()
    threads = [threading.Thread(target=body, args=(r,), name=f"engine-{i}")
               for i, r in enumerate(runners)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
