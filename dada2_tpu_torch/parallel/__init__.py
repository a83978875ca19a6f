"""Multi-device distribution: meshes, sharded compare, collectives.

`use_mesh(mesh)` makes every subsequently-created compare backend that is
given neither a device nor a mesh shard its block grid over the mesh's
"pairs" axis (see core/backend_cuda.py); `dist` holds the meshes, the
sharded compare-and-tally step, the multi-device dry run and the
torch.distributed collectives of multi-process runs.
"""
from __future__ import annotations

_MESH = None


def use_mesh(mesh) -> None:
    """Set the process-wide device mesh for compare sweeps. The mesh must
    have a "pairs" axis; pass None to return to single-device."""
    global _MESH
    if mesh is not None and "pairs" not in getattr(mesh, "shape", {}):
        raise ValueError('mesh must have a "pairs" axis')
    _MESH = mesh


def get_mesh():
    return _MESH


from .dist import (build_compare_and_tally, cpu_devices,  # noqa: E402
                   dryrun_multichip, make_mesh, trans_tally)
