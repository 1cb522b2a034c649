"""Multi-process bootstrap (``boslam_tpu.parallel.distributed``).

Every process runs the same program and joins one ``torch.distributed``
process group; meshes built from it (``parallel.mesh.make_mesh``) carry
the sharded solvers' collectives: NCCL between cards, gloo on the CPU.

## Launch recipe

One process per card, all started with the same command:

    # host 0 (also the coordinator)
    BOSLAM_COORDINATOR=host0:8476 BOSLAM_NUM_PROCESSES=2 BOSLAM_PROCESS_ID=0 \
        python -m boslam_tpu_torch.main --tum ... --distributed --global-ba
    # host 1
    BOSLAM_COORDINATOR=host0:8476 BOSLAM_NUM_PROCESSES=2 BOSLAM_PROCESS_ID=1 \
        python -m boslam_tpu_torch.main --tum ... --distributed --global-ba

``BOSLAM_COORDINATOR`` may also be a URL (``file:///shared/rdzv``), used as
the ``init_method`` as it stands.  Without it, ``--distributed`` (or
``BOSLAM_DISTRIBUTED=1``) reads torchrun's variables (``env://``:
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), so
``torchrun --nproc-per-node 4 -m boslam_tpu_torch.main --distributed ...``
runs four ranks on four cards.  Each rank works on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

_ENV_COORD = "BOSLAM_COORDINATOR"
_ENV_NPROC = "BOSLAM_NUM_PROCESSES"
_ENV_PID = "BOSLAM_PROCESS_ID"
_ENV_FLAG = "BOSLAM_DISTRIBUTED"

_initialized = False


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK or 0}`` unless ``device`` says
    otherwise (``"cpu"``, or a CUDA device with its index)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def maybe_initialize(force: bool = False, device=None,
                     timeout: float = 600.0, backend=None) -> bool:
    """Join the process group if requested; idempotent.

    Requested means ``force=True`` (the CLI's ``--distributed``), or
    BOSLAM_COORDINATOR / BOSLAM_DISTRIBUTED=1 in the environment.  With
    BOSLAM_COORDINATOR the (coordinator, num_processes, process_id) triple
    is used; otherwise torchrun's ``env://`` variables.  The backend is
    NCCL for a CUDA ``device`` (the default) and gloo for the CPU unless
    ``backend`` names one (gloo also carries CUDA tensors, through the
    host: NCCL refuses two ranks on one card); every collective fails after
    ``timeout`` seconds instead of hanging.  Returns
    True iff the group is (now) up; a failure is printed and returns False,
    as the reference does.
    """
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get(_ENV_COORD)
    flagged = os.environ.get(_ENV_FLAG, "0") not in ("0", "", "false")
    if not (force or coord or flagged):
        return False
    dev = rank_device(device)
    try:
        kw = {}
        if coord:
            kw = dict(
                init_method=coord if "://" in coord else f"tcp://{coord}",
                world_size=int(os.environ.get(_ENV_NPROC, "1")),
                rank=int(os.environ.get(_ENV_PID, "0")),
            )
        else:
            kw = dict(init_method="env://")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(
            backend,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        _initialized = True
    except Exception as e:
        print(f"[distributed] initialize failed ({e}); "
              "continuing single-process", file=sys.stderr)
        return False
    return True


def is_initialized() -> bool:
    return _initialized


def runtime_info() -> dict:
    """Process / device topology after (maybe) initialisation; one device
    per process."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "initialized": _initialized,
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "global_devices": world,
        "local_devices": 1,
    }
