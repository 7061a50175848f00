"""Multi-card rendering and training: ray-sharded data parallelism over
``torch.distributed``.

The port of ``brickmap_tpu/parallel/render.py``.  Where the JAX package
traces one program over a device mesh (``shard_map``), here every rank is a
process that runs its shard eagerly and meets the others in collectives:

* **Forward** (:func:`render_wave_sharded`): pixels split into equal
  contiguous row-major blocks, one per rank; the scene is replicated (every
  rank holds the same world); the blocks are ``all_gather``ed so that every
  rank returns the whole frame, and the ray counts ``all_reduce``d.
* **Inverse** (:func:`inverse_train_step`, :func:`inverse_train_step_sparse`):
  each rank takes the loss and gradients of its ray shard, then their mean
  over the group (``all_reduce`` SUM / d, JAX's ``pmean``); the sparse
  step's gradients, the views of one ``field4`` (``diff/field4.py``, the
  sparse fields' one layout), are reduced as that ``field4``, in place.

Backends: gloo for CPU tensors, NCCL for CUDA tensors
(:func:`brickmap_tpu_torch.app.scaling.init_distributed` picks it from the
device).  The sparse step records against the port's flat scene, as
:func:`~brickmap_tpu_torch.diff.sparse.l2_loss_and_grads_sparse` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..config import BrickmapConfig, MeshConfig
from ..diff.field4 import field4_of
from ..diff.render import l2_loss_and_grads
from ..diff.sparse import l2_loss_and_grads_sparse
from ..render.pathtrace import wave_for_indices

__all__ = ["Mesh", "make_mesh", "render_wave_sharded", "inverse_train_step",
           "inverse_train_step_sparse", "replicate", "shard_rays"]


@dataclass(frozen=True)
class Mesh:
    """The ranks ``[0, size)`` of the world as one data-parallel axis.

    ``group`` is their process group and ``rank`` this process's place in
    it; on a rank outside the mesh both are ``None`` / -1.  ``device`` is
    where this rank keeps its tensors.
    """

    group: object
    size: int
    rank: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0


def make_mesh(num_devices: int | MeshConfig | None = None,
              device=None) -> Mesh:
    """The first ``num_devices`` ranks of the world (all when None); a
    :class:`~brickmap_tpu_torch.config.MeshConfig` (``cfg.mesh``) gives its
    ``num_devices``.

    A collective: every rank of the world calls it (``dist.new_group``),
    those outside get a mesh with ``member`` False.  ``device`` defaults to
    the current CUDA device under NCCL and to the CPU under gloo.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "app.scaling.init_distributed first")
    if isinstance(num_devices, MeshConfig):
        num_devices = num_devices.num_devices
    world = dist.get_world_size()
    d = world if num_devices is None else num_devices
    if not 1 <= d <= world:
        raise ValueError(f"make_mesh: {d} ranks of a world of {world}")
    group = dist.new_group(list(range(d)))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    rank = dist.get_rank()
    if rank >= d:
        return Mesh(None, d, -1, torch.device(device))
    return Mesh(group, d, rank, torch.device(device))


def _require_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")


def replicate(mesh: Mesh, tree):
    """Each tensor (or scene) leaf of ``tree`` on this rank's device.  Every
    rank passes the same values (built from the same seed)."""
    return tree_map(lambda x: x.to(mesh.device) if hasattr(x, "to") else x,
                    tree)


def shard_rays(mesh: Mesh, tree):
    """This rank's contiguous block of each leaf's leading (ray) axis, on its
    device.  The axis must divide by the mesh size (JAX's ``P(axis)``)."""
    _require_member(mesh)

    def shard(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"shard_rays: {n} rays do not divide over "
                             f"{mesh.size} ranks")
        local = n // mesh.size
        return x[mesh.rank * local:(mesh.rank + 1) * local].to(mesh.device)

    return tree_map(shard, tree)


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _pmean_(mesh: Mesh, *tensors) -> None:
    """Replace each tensor by its mean over the mesh, in place.  The
    non-contiguous ones must be the two views of one ``field4`` (the sparse
    step's gradients), which is reduced once; else this raises, since a
    strided tensor would be reduced in a copy."""
    flats = [t.view(-1) for t in tensors if t.is_contiguous()]
    strided = [t for t in tensors if not t.is_contiguous()]
    if strided:
        field4 = field4_of(*strided) if len(strided) == 2 else None
        if field4 is None:
            raise ValueError("_pmean_: non-contiguous tensors that are not "
                             "the views of one field4")
        flats.append(field4.view(-1))
    for f in flats:
        dist.all_reduce(f, group=mesh.group)
        f.div_(mesh.size)


def render_wave_sharded(mesh: Mesh, scene, camera_arrays: dict, cam_brick,
                        cfg: BrickmapConfig, width: int, height: int,
                        generator=None, uniforms=None):
    """One sample wave with pixels sharded across the mesh.

    Rank s renders ``idx = (s*local + arange(local)) % n``, ``local =
    ceil(n/d)``: contiguous row-major blocks, and when n does not divide by
    d the last rank wraps around and re-renders leading pixels (dropped
    from the result).  ``uniforms`` / ``generator`` are this rank's, in its
    ``idx`` order (JAX folds the key with the shard index).  Every rank
    returns the whole frame: (rgb [N,3], count [N], requests with ``mask``
    [N], ``pos`` [N,3] and the summed ``traced_rays``, ``exhausted_rays``).
    """
    _require_member(mesh)
    n = width * height
    local = -(-n // mesh.size)
    idx = (mesh.rank * local
           + torch.arange(local, device=scene.device)) % n
    rgb, count, req = wave_for_indices(scene, idx, camera_arrays, cam_brick,
                                       cfg, width, height, generator,
                                       uniforms)
    rays = torch.stack([req["traced_rays"], req["exhausted_rays"]]).to(
        torch.int64)
    dist.all_reduce(rays, group=mesh.group)
    # gloo has no bool collectives: the mask travels as uint8.
    mask = _all_gather(mesh, req["mask"].to(torch.uint8))[:n].bool()
    return (_all_gather(mesh, rgb)[:n], _all_gather(mesh, count)[:n],
            {"mask": mask, "pos": _all_gather(mesh, req["pos"])[:n],
             "traced_rays": rays[0], "exhausted_rays": rays[1]})


def inverse_train_step(mesh: Mesh, origin, direction, occupancy, albedo,
                       background, target, max_steps: int = 192):
    """One data-parallel gradient step of the dense compositor.

    ``origin``/``direction``/``background``/``target`` are this rank's ray
    shard (:func:`shard_rays`), the grids replicated.  Returns (loss,
    grad_occupancy, grad_albedo), each the mean over the mesh, the same on
    every rank.
    """
    _require_member(mesh)
    loss, (docc, dalb) = l2_loss_and_grads(origin, direction, occupancy,
                                           albedo, background, target,
                                           max_steps=max_steps)
    _pmean_(mesh, loss, docc, dalb)
    return loss, docc, dalb


def inverse_train_step_sparse(mesh: Mesh, origin, direction, scene, cellmap,
                              occupancy, albedo, background, target, grid,
                              k_segments: int = 8):
    """Data-parallel gradient step over the sparse pool fields: each rank
    records (B3) and replays (B4f/B4b) its ray shard against the replicated
    flat scene and fields; the loss and gradients are averaged over the
    mesh.  Returns (loss, grad_occupancy, grad_albedo) on every rank."""
    _require_member(mesh)
    loss, (docc, dalb) = l2_loss_and_grads_sparse(
        origin, direction, scene, cellmap, occupancy, albedo, background,
        target, grid, k_segments=k_segments)
    _pmean_(mesh, loss, docc, dalb)
    return loss, docc, dalb
