"""Production meshes (the torch port of ``repro.launch.mesh``).

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  512 ranks as (pod=2, data=16, model=16) — the 'pod' axis carries
the slower inter-pod links, so the rules place only data-parallel (gradient
reduce) traffic on it.

Both are ``DeviceMesh``es over the world the caller started with
``torch.distributed.init_process_group`` (a real one, or the ``fake``
backend of the dry-run, which holds 256 or 512 ranks in one process).
FUNCTIONS, not module constants: importing this module touches no
process-group state.  A mesh of CUDA ranks on a gloo world (several ranks
on one card) is used inside ``sharding.partitioning.gloo_cuda_collectives``,
which the caller enters (the launcher does).
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_host_mesh"]


def _make_mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        from ..core.assembly import resolve_device

        device_type = resolve_device(None).type
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(16, 16) over ('data', 'model'), or (2, 16, 16) over ('pod', 'data',
    'model'); ``device_type`` the ranks' device (the CUDA card unless the
    caller names another; the dry-run's ``meta`` stand-ins live on a
    ``cpu`` mesh)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str | None = None):
    """A (data, model) mesh over the started world, whose size must be
    data × model — used by the launcher and the tests."""
    return _make_mesh((data, model), ("data", "model"), device_type)
