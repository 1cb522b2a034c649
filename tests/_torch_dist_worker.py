"""One rank of the port's multi-process tests, on the CPU over gloo.

    python tests/_torch_dist_worker.py MODE RANK WORLD RDZV IN_NPZ OUT_NPZ

joins the process group through the port's own bootstrap
(``BOSLAM_COORDINATOR=file://RDZV``), runs MODE on the inputs the parent
test saved, and saves this rank's results.  It imports only torch, numpy
and the port; the JAX side of each comparison runs in the parent.

Modes:
  sharded_ba  ``make_sharded_ba`` on this rank's stripe of a local-BA
              problem (inputs: cfg JSON, poses0, pts0, edge fields, opt,
              n_iters); saves poses, the rank's points and both costs.
  global_ba   ``distributed_global_ba`` of a map (inputs: cfg JSON, the
              MapState fields, lm_iters, cg_iters); saves the whole
              refined map's poses and points, costs and the edge count.
"""

import json
import os
import sys

import numpy as np
import torch


def main() -> None:
    mode, rank, world, rdzv, src, dst = sys.argv[1:7]
    os.environ.update(BOSLAM_COORDINATOR=f"file://{rdzv}",
                      BOSLAM_NUM_PROCESSES=world, BOSLAM_PROCESS_ID=rank)
    torch.set_num_threads(1)
    from boslam_tpu_torch import convert
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.parallel.distributed import maybe_initialize
    from boslam_tpu_torch.parallel.mesh import make_mesh

    assert maybe_initialize(device="cpu", timeout=120.0)
    mesh = make_mesh()
    assert mesh.shape["pt"] == int(world)
    d = dict(np.load(src))
    cfg = SlamConfig.from_dict(json.loads(str(d.pop("cfg"))))
    if mode == "sharded_ba":
        from boslam_tpu_torch.parallel.sharded_ba import (
            make_sharded_ba, shard_edges_by_point, shard_rows, stripe_points,
        )
        from boslam_tpu_torch.solvers.ba_core import BaEdges

        n, r = mesh.shape["pt"], mesh.index("pt")
        edges = BaEdges(*(torch.from_numpy(d[f]) for f in BaEdges._fields))
        pts0 = torch.from_numpy(d["pts0"])
        e_sh, _ = shard_edges_by_point(edges, pts0.shape[0], n)
        p_sh, perm = stripe_points(pts0, n)
        fn = make_sharded_ba(cfg, mesh, n_iters=int(d["n_iters"]))
        poses, pts, c0, c1 = fn(torch.from_numpy(d["poses0"]),
                                shard_rows(p_sh, n, r),
                                shard_rows(e_sh, n, r),
                                torch.from_numpy(d["opt"]))
        out = dict(poses=poses.numpy(), pts=pts.numpy(), perm=perm,
                   cost0=c0.numpy(), cost1=c1.numpy())
    elif mode == "global_ba":
        from boslam_tpu_torch.parallel.sharded_global_ba import (
            distributed_global_ba,
        )

        state = convert.map_state_from_numpy(d, "cpu")
        st, (c0, c1, n_edges) = distributed_global_ba(
            cfg, mesh, state, lm_iters=int(d["lm_iters"]),
            cg_iters=int(d["cg_iters"]), device="cpu")
        out = dict(kf_pose=st.kf_pose.numpy(), pt_xyz=st.pt_xyz.numpy(),
                   cost0=c0, cost1=c1, n_edges=n_edges)
    else:
        raise ValueError(mode)
    np.savez(dst, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
