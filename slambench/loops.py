"""The loop cells: a frame cell (``frames.py``'s stages) whose sequence
closes a loop in every engine, with the loop correction checked.

``PoseGraphProbe`` watches the flush's loop correction from outside: the
map that ``solvers.pose_graph.build_essential_edges`` builds the essential
graph from (after the loop's points are fused and its edge recorded, its
poses not yet moved), and the keyframe poses of the map that
``close_loop_update`` hands back to the engine, copied on the device (no
host read).  The check works the graph and its solve out again in float64
(``reference.pose_graph``) from the window's last closure and compares the
objective at the program's poses with that at the reference's own
solution.  ``loop_closures_missing`` counts the engines that fed the whole
sequence inside the window without closing a loop.
"""

from __future__ import annotations

import sys

import torch

import frames
from reference import pose_graph as ref_pg

# The map's arrays the essential graph is built from.
GRAPH_INPUTS = ("kf_pose", "kf_valid", "spanning_parent", "covis",
                "loop_edges", "loop_rel", "n_loop_edges")


class PoseGraphProbe:
    """While ``on``, ``last`` holds the newest closure: (the map its graph
    was built from, the keyframe, the candidate, the loop's measured
    ``T_kf T_cand^-1``, the poses the engine's map holds after it).  A
    closure whose graph was never built keeps the map None."""

    def __init__(self, slam_module, pose_graph_module):
        self.slam, self.pg = slam_module, pose_graph_module
        self.close_loop = slam_module.close_loop_update
        self.build = pose_graph_module.build_essential_edges
        self.last, self.on, self._graph = None, False, None
        slam_module.close_loop_update = self._close_loop
        pose_graph_module.build_essential_edges = self._build

    def _build(self, cfg, state, *args, **kw):
        if self.on:
            self._graph = {k: getattr(state, k).clone() for k in GRAPH_INPUTS}
        return self.build(cfg, state, *args, **kw)

    def _close_loop(self, cfg, state, kf_id, cand, t_rel, *args):
        self._graph = None
        out, pose_kf = self.close_loop(cfg, state, kf_id, cand, t_rel, *args)
        if self.on:
            self.last = (self._graph, kf_id.clone(), cand.clone(),
                         t_rel.clone(), out.kf_pose.clone())
        return out, pose_kf

    def close(self):
        self.slam.close_loop_update = self.close_loop
        self.pg.build_essential_edges = self.build

    def values(self, slam_cfg, device):
        """No closure in the window, or none that built its graph: the
        number is missing."""
        if self.last is None or self.last[0] is None:
            return {}
        return pose_graph_gap(self.last, slam_cfg, device)


def pose_graph_gap(closure, slam_cfg, device):
    """The float64 objective of the closure's essential graph at the
    program's poses against that at the reference's own solve from the
    same map, as a share of the latter."""
    graph, kf_id, cand, t_rel, prog = closure
    m = {k: v.to(device) for k, v in graph.items()}
    g, start, ref = ref_pg.loop_solve(
        m, int(kf_id), int(cand), t_rel.to(device),
        slam_cfg["map"]["covis_essential_weight"], slam_cfg["loop"]["pg_iters"])
    f0 = float(ref_pg.objective(g, start))
    f_ref = float(ref_pg.objective(g, ref))
    f_prog = float(ref_pg.objective(g, prog.to(device, torch.float64)))
    print(f"[slambench] last loop closure: keyframe {int(kf_id)} onto "
          f"{int(cand)}, {int(m['kf_valid'].sum())} keyframes, "
          f"{g.i.shape[0]} edges; objective {f0:.6g} -> program "
          f"{f_prog:.6g}, reference {f_ref:.6g}", file=sys.stderr, flush=True)
    return {"pg_cost_rel_gap": abs(f_prog - f_ref) / f_ref}


def closures_missing(win: frames.Window) -> dict:
    done = win.stream.engines[:win.complete]
    missing = sum(not any(r.get("event") == "loop_closed" for r in e.metrics)
                  for e in done)
    print(f"[slambench] engines that fed the whole sequence: {len(done)}, "
          f"loop closures {[e.n_loops_closed for e in done]}",
          file=sys.stderr, flush=True)
    return {"loop_closures_missing": float(missing)}


def run(spec, **kw):
    import boslam_tpu_torch.slam as slam_module
    import boslam_tpu_torch.solvers.pose_graph as pose_graph

    probes = [frames.LocalBaProbe(slam_module),
              PoseGraphProbe(slam_module, pose_graph)]
    return frames.run_cell(spec, probes, closures_missing, **kw)
