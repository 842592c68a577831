"""One rank of a parallel.launcher.launch:

    python -m libpll2_tpu_torch.parallel._rank DIR RANK N DEVICE TARGET

joins the process group through the FileStore DIR/store, runs TARGET
("module:function") as function(mesh, **kwargs) with the kwargs of
DIR/args.pkl, writes its result, tensors on the CPU, to DIR/rank<RANK>.pkl
and exits 0; on any error it prints the traceback and exits 1.
"""
from __future__ import annotations

import importlib
import os
import pathlib
import pickle
import sys
import traceback

import torch
import torch.distributed as dist

from .distributed import initialize
from .sharding import make_mesh


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(work: pathlib.Path, rank: int, n: int, device: str,
               target: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    initialize(coordinator_address=f"file://{work / 'store'}",
               num_processes=n, process_id=rank)
    mesh = make_mesh(["cpu"] * n if device == "cpu" else None)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    with open(work / "args.pkl", "rb") as f:
        kwargs = pickle.load(f)
    result = _to_host(fn(mesh, **kwargs))
    with open(work / f"rank{rank}.pkl.tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(work / f"rank{rank}.pkl.tmp", work / f"rank{rank}.pkl")
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(pathlib.Path(sys.argv[1]), int(sys.argv[2]),
                   int(sys.argv[3]), sys.argv[4], sys.argv[5])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
