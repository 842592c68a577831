"""Debug printers and the hardware probe (reference: libpll-2
src/output.c, src/hardware.c).  Counterpart of libpll2_tpu/utils/output.py.

The printers define the reference's golden-file format and are
replicated byte for byte ("%+2.*f   " / "{(p,p,p,p),...}" forms, scaling
undone for display, output.c:26-101).  The hardware probe is the analog
of cpuid detection (hardware.c:166-196): it reports the CUDA device that
torch sees.
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np
import torch


def format_pmatrix(pmatrix: np.ndarray, float_precision: int = 4) -> str:
    """pll_show_pmatrix (output.c:26-46): pmatrix [R, S, S]."""
    fp = io.StringIO()
    R, S, _ = pmatrix.shape
    for k in range(R):
        for i in range(S):
            for j in range(S):
                fp.write(f"%+2.{float_precision}f   "
                         % pmatrix[k, i, j])
            fp.write("\n")
        fp.write("\n")
    return fp.getvalue()


def format_clv(clv: np.ndarray, scaler: Optional[np.ndarray],
               sites: int, float_precision: int = 4,
               scale_threshold: float = 2.0 ** -256,
               site_id: Optional[np.ndarray] = None) -> str:
    """pll_show_clv (output.c:56-101): clv [R, S, T] engine layout;
    scaling is undone for display; repeats dereferenced via site_id."""
    fp = io.StringIO()
    R, S, _ = clv.shape
    fp.write("[ ")
    for s in range(sites):
        i = int(site_id[s]) if site_id is not None else s
        fp.write("{")
        for j in range(R):
            fp.write("(")
            vals = clv[j, :, i].astype(np.float64)
            if scaler is not None:
                vals = vals * scale_threshold ** int(
                    scaler[i] if np.ndim(scaler) == 1 else scaler[j, i])
            fp.write(",".join(f"%.{float_precision}f" % v for v in vals))
            fp.write(")")
            if j < R - 1:
                fp.write(",")
        fp.write("} ")
    fp.write("]\n")
    return fp.getvalue()


def show_pmatrix(partition, index: int, float_precision: int = 4) -> None:
    print(format_pmatrix(partition.get_pmatrix(index), float_precision),
          end="")


def show_clv(partition, clv_index: int, scaler_index: int,
             float_precision: int = 4) -> None:
    from ..constants import SCALE_BUFFER_NONE
    scaler = (None if scaler_index == SCALE_BUFFER_NONE
              else partition.scalers[scaler_index].cpu().numpy())
    clv = partition.clv[clv_index].to(torch.float64).cpu().numpy()
    print(format_clv(clv, scaler, partition.cfg.sites, float_precision,
                     partition.cfg.scale_threshold,
                     site_id=partition.get_site_id(clv_index)),
          end="")


def hardware_probe() -> dict:
    """pll_hardware_probe (hardware.c:166-173): the CUDA device torch
    sees — name, count, compute capability, total memory — or, without
    one, cuda_available False and the other fields None; and how the
    sites can be sharded: the processes of the default process group
    (parallel.initialize) and this one's rank, 1 and 0 without one."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    info = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "cuda_available": torch.cuda.is_available(),
            "device_count": 0, "device_name": None,
            "compute_capability": None, "total_memory": None,
            "process_count": dist.get_world_size() if grouped else 1,
            "rank": dist.get_rank() if grouped else 0}
    if info["cuda_available"]:
        props = torch.cuda.get_device_properties(0)
        info.update(device_count=torch.cuda.device_count(),
                    device_name=props.name,
                    compute_capability=f"{props.major}.{props.minor}",
                    total_memory=props.total_memory)
    return info


def hardware_dump() -> None:
    """pll_hardware_dump analog (hardware.c:174-190)."""
    print("CUDA hardware probe:")
    for k, v in hardware_probe().items():
        print(f"  {k}: {v}")
