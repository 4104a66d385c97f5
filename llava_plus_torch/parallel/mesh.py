"""Device mesh construction over DTensor.

Counterpart of ``llava_plus_tpu/parallel/mesh.py``. A mesh has three axes:

- ``dp``:   pure data parallelism (gradients reduced over it);
- ``fsdp``: parameters and optimizer state sharded over it, and the batch;
- ``tp``:   tensor parallelism (attention heads, MLP columns).

The JAX package builds a ``jax.sharding.Mesh`` over the chips of one
process and lets GSPMD place every collective. Here the mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group (one process a device; the caller initialises the group), parameters
and batches are ``DTensor``s placed by the spec tables of
``parallel/sharding.py``, and DTensor's ops insert the collectives.

A spec, as in JAX's ``PartitionSpec``, has one entry a tensor dim: None, an
axis name, or a tuple of names. A dim named by several axes is sharded over
each of them, the first name major (DTensor's order of mesh dims, so a
tuple must list its axes in mesh order, as every table here does).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

AXES = ("dp", "fsdp", "tp")
BATCH = ("dp", "fsdp")   # the batch dim's axes

# the mesh that ``constrain`` binds to (held around a train step)
_ACTIVE_MESH: contextvars.ContextVar[Optional[DeviceMesh]] = contextvars.ContextVar(
    "llava_active_mesh", default=None)


@contextlib.contextmanager
def activate_mesh(mesh: Optional[DeviceMesh]):
    """Make ``constrain`` calls inside model code bind to this mesh, and the
    kernels' wrappers run on local shards. Without an active mesh every
    ``constrain`` is a no-op, so single-device paths are untouched."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE_MESH.get()


def placements(mesh: DeviceMesh, spec) -> tuple:
    """A spec (one entry a tensor dim) -> DTensor placements, one a mesh
    dim. Names the mesh lacks are dropped."""
    names = mesh.mesh_dim_names or ()
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept = [a for a in axes if a in names]
        if [names.index(a) for a in kept] != sorted(names.index(a) for a in kept):
            raise ValueError(f"spec entry {entry!r} must list its axes in mesh order {names}")
        for a in kept:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def constrain(x: torch.Tensor, *dims) -> torch.Tensor:
    """Redistribute ``x`` to the spec ``dims`` over the active mesh (no-op
    without one): the counterpart of JAX's ``with_sharding_constraint``.
    Each dim is None, an axis name, or a tuple of names; names absent from
    the mesh are dropped, so the same model code runs on any mesh shape. A
    plain tensor is taken as replicated (the same on every rank). A DTensor
    binds to its own mesh where none is active (the backward's recompute of
    a remat layer may run on autograd's device thread, outside the
    context)."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None and isinstance(x, DTensor):
        mesh = x.device_mesh
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = placements(mesh, dims)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def to_local(x: DTensor, *dims, partial: Sequence[str] = ()) -> torch.Tensor:
    """``x`` redistributed to the spec ``dims`` and its local shard, for a
    kernel or a step that has no DTensor rule. The shard's gradient is
    taken as ``partial`` over the named axes (each rank holds a part of the
    sum: a product contracted over a sharded dim, or a replicated weight
    used by a batch shard) and as the shard's own placement elsewhere."""
    x = constrain(x, *dims)
    grad = None
    if partial:
        names = x.device_mesh.mesh_dim_names
        grad = tuple(Partial() if names[i] in partial else p
                     for i, p in enumerate(x.placements))
    return x.to_local(grad_placements=grad)


def from_local(t: torch.Tensor, mesh: DeviceMesh, *dims) -> DTensor:
    """The DTensor whose local shard on this rank is ``t``, placed by the
    spec ``dims`` (every rank passes its own shard)."""
    return DTensor.from_local(t, mesh, placements(mesh, dims), run_check=False)


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1, *,
              devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, fsdp, tp) mesh over the ranks ``devices`` (default: every rank
    of the default process group, which must be initialised). ``fsdp=None``
    absorbs the remaining ranks; ``tp`` is innermost, so tensor-parallel
    collectives run between neighbouring ranks (on one host, over NVLink)."""
    import torch.distributed as dist

    devices = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(devices)
    if fsdp is None:
        assert n % (dp * tp) == 0, (n, dp, tp)
        fsdp = n // (dp * tp)
    need = dp * fsdp * tp
    assert need <= n, f"{dp}x{fsdp}x{tp} > {n} devices"
    ranks = torch.tensor(devices[:need], dtype=torch.int64).reshape(dp, fsdp, tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(1, 1, 1, devices=[0], device_type=device_type)


def shardings(mesh: DeviceMesh, spec_tree):
    """Spec tree (dicts and lists whose leaves are spec tuples) ->
    placements tree."""
    if isinstance(spec_tree, dict):
        return {k: shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [shardings(mesh, v) for v in spec_tree]
    return placements(mesh, spec_tree)


def batch_spec() -> tuple:
    """Activations and batch arrays: the batch dim over dp and fsdp."""
    return (("dp", "fsdp"),)
