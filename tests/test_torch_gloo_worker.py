"""One rank of the gloo process groups of tests/test_torch_parallel.py.

    python tests/test_torch_gloo_worker.py INPUTS.npz OUT_DIR WORLD RANK PORT

Joins a CPU world of WORLD processes at 127.0.0.1:PORT, runs every sharded
case of the port on the inputs the test made (``brickmap_tpu_torch.parallel``
and ``InverseRenderer(mesh=...)``) and writes this rank's results to
``OUT_DIR/r<RANK>.npz``.  Imports torch and the port only; the test holds
the results against the JAX package.  Holds no test itself.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 128
BOUNCES, TOP_STEPS = 1, 64
RESOLUTIONS = ((32, 16), (33, 15))   # 33 x 15 divides by neither 2 nor 4
DENSE_STEPS = 32
K = 4   # segments a ray in the sparse step (interpret-mode JAX time)


def configs():
    from brickmap_tpu_torch.config import BrickmapConfig, GridConfig, \
        RenderConfig

    return BrickmapConfig(
        grid=GridConfig(grid_size=GRID, grid_height=GRID),
        render=RenderConfig(width=32, height=16, max_bounces=BOUNCES,
                            max_top_steps=TOP_STEPS))


def uniform_key(d, res, shard, name):
    return f"u{d}_{res[0]}x{res[1]}_{shard}_{name}"


def run(inputs: str, out_dir: str, world: int, rank: int, port: int) -> None:
    from brickmap_tpu_torch import scene as tscene
    from brickmap_tpu_torch.app.scaling import init_distributed
    from brickmap_tpu_torch.diff.optim import InverseRenderer
    from brickmap_tpu_torch.diff.sparse import cell_pool_map
    from brickmap_tpu_torch.parallel import render as par

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    try:
        mesh = par.make_mesh()
        assert mesh.size == world and mesh.rank == rank
        x = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
        cfg = configs()
        out = {}

        # The sharded wave, this rank's uniforms, at each resolution.
        sc = par.replicate(mesh, tscene.scene_from_numpy(
            x["iv"].numpy(), x["pw"].numpy(), x["pb"].numpy(), device="cpu"))
        cam_brick = tuple(int(c) for c in x["cam_brick"])
        for res in RESOLUTIONS:
            tag = f"{res[0]}x{res[1]}"
            arrays = {k[len(tag) + 4:]: v for k, v in x.items()
                      if k.startswith(f"cam{tag}_")}
            u = {n: x[uniform_key(world, res, rank, n)]
                 for n in ("stratum", "jitter", "lens", "cone", "hemi")}
            rgb, count, req = par.render_wave_sharded(
                mesh, sc, arrays, cam_brick, cfg, *res, uniforms=u)
            out.update({f"wave{tag}_rgb": rgb, f"wave{tag}_count": count,
                        f"wave{tag}_mask": req["mask"],
                        f"wave{tag}_pos": req["pos"],
                        f"wave{tag}_traced": req["traced_rays"],
                        f"wave{tag}_exhausted": req["exhausted_rays"]})

        # The dense step: every rank passes the whole batch to shard_rays.
        o, d, bg, tgt = par.shard_rays(
            mesh, (x["dense_o"], x["dense_d"], x["dense_bg"], x["dense_tgt"]))
        occ, alb = par.replicate(mesh, (x["dense_occ"], x["dense_alb"]))
        loss, docc, dalb = par.inverse_train_step(mesh, o, d, occ, alb, bg,
                                                  tgt, max_steps=DENSE_STEPS)
        out.update(dense_loss=loss, dense_docc=docc, dense_dalb=dalb)

        # The sparse step over the flat scene.
        ssc = tscene.scene_from_numpy(x["s_iv"].numpy(), x["s_pw"].numpy(),
                                      x["s_pb"].numpy(), device="cpu")
        o, d, bg, tgt = par.shard_rays(
            mesh, (x["s_o"], x["s_d"], x["s_bg"], x["s_tgt"]))
        loss, docc, dalb = par.inverse_train_step_sparse(
            mesh, o, d, ssc, cell_pool_map(ssc, cfg.grid), x["s_occ"],
            x["s_alb"], bg, tgt, cfg.grid, k_segments=K)
        out.update(sparse_loss=loss, sparse_docc=docc, sparse_dalb=dalb)

        # One step of InverseRenderer(mesh=...).
        ir = InverseRenderer(grid_shape=(8, 8, 8),
                             max_steps_per_ray=DENSE_STEPS, mesh=mesh)
        loss = ir.train_step(x["dense_o"], x["dense_d"], x["dense_bg"],
                             x["dense_tgt"])
        out.update(ir_loss=torch.tensor(loss), ir_occ=ir.occupancy,
                   ir_alb=ir.albedo)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    run(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:6]))
