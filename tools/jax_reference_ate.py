"""ATE and events of the JAX reference engine on a named sequence of
``tools/sequences.py``.

The PyTorch port is held to these numbers: ``chip_smoke.py`` holds its runs
of ``orbit``, ``kidnap`` and ``loop`` to the constants this tool printed,
and ``tools/torch_sequence.py`` runs the port on the same frames.  Without
``--loops``, ``SlamSystem.MAX_VERIFY = 0`` keeps the host from ever
verifying a loop; ``--loops`` leaves it at the reference's 4.  ``--global-ba`` runs one
``SlamSystem.run_global_ba()`` after the run, as ``main.py --global-ba``
does after its final flush (without the per-closure hook, so the events
stay the run's own).  ``--async-mapping`` runs the engine with
``async_mapping=True`` (local BA deferred to the flushes).

    JAX_PLATFORMS=cpu python tools/jax_reference_ate.py
        [--sequence orbit|hall|kidnap|loop|survey] [--loops] [--global-ba]
        [--async-mapping] [--seed S] [--frames N] [--out traj.npy]
    JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --ba-problem
    JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --batched

Prints one JSON line: ATE (m), keyframes, points, lost frames,
keyframe-event frame indices, the frames with a relocalization attempt and
with a success, the path each attempt took (``bow`` once the vocabulary is
trained, else ``global``), the loops closed, and with ``--global-ba`` the
ATE after global BA, its costs and its edge count.

``--ba-problem`` runs instead the bench's synthetic global-BA problem
(``bench.py:bench_global_ba``: ``synthetic_ba_problem`` at rng seed 0, 256
keyframes, 50000 points, 512 observations per keyframe; 6 LM and 40 CG
iterations) and prints its edges, landmarks, costs and largest pose error
against ground truth.

``--batched`` runs instead ``parallel.multi.run_sequences`` on the four
sequences of ``sequences.BATCH`` (``kidnap`` and the three ``batch_``
orbits, unequal in length) over a 4-device 'seq' mesh of the CPU, and
prints one JSON line with each sequence's ATE, keyframes, points and
events (``sequences.batch_events``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

import sequences  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="orbit")
    ap.add_argument("--frames", type=int, default=None,
                    help="keep the first N frames of the sequence")
    ap.add_argument("--out", type=str, default=None,
                    help="optional .npy path for the anchored trajectory")
    ap.add_argument("--loops", action="store_true",
                    help="verify and close loops (MAX_VERIFY stays 4)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine's seed (its RANSAC draws)")
    ap.add_argument("--global-ba", action="store_true",
                    help="run global BA once after the run")
    ap.add_argument("--async-mapping", action="store_true",
                    help="defer local BA to the flushes (async mapping)")
    ap.add_argument("--ba-problem", action="store_true",
                    help="run the bench's synthetic global-BA problem")
    ap.add_argument("--batched", action="store_true",
                    help="run the four sequences of sequences.BATCH with "
                         "parallel.multi.run_sequences")
    args = ap.parse_args()
    if args.ba_problem:
        ba_problem()
        return
    if args.batched:
        batched()
        return

    import jax.numpy as jnp

    from boslam_tpu.config import SlamConfig
    from boslam_tpu.geometry import align
    from boslam_tpu.io import synthetic
    from boslam_tpu.slam import SlamSystem

    cfg, traj, frames = sequences.build(args.sequence, SlamConfig, synthetic,
                                        args.frames)
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, seed=args.seed, async_mapping=args.async_mapping)
    if not args.loops:
        slam.MAX_VERIFY = 0
    vocab_ready = []  # what each frame's step sees
    for ts, rgb, depth in frames:
        vocab_ready.append(bool(slam.loop.vocab_ready))
        slam.feed(ts, rgb, depth)
    slam.flush()
    _, est = slam.trajectory()
    rmse, _ = align.ate_rmse(jnp.asarray(est[:, 4:]),
                             jnp.asarray(traj.poses_twc[:, 4:]))
    gba = {}
    if args.global_ba:
        t1 = time.perf_counter()
        rec = slam.run_global_ba()
        cpu_s = time.perf_counter() - t1
        _, est = slam.trajectory()
        after, _ = align.ate_rmse(jnp.asarray(est[:, 4:]),
                                  jnp.asarray(traj.poses_twc[:, 4:]))
        gba = dict(ate_after_global_ba_m=float(after),
                   gba_cost0=rec["gba_cost0"], gba_cost1=rec["gba_cost1"],
                   gba_edges=rec["gba_edges"], gba_cpu_seconds=cpu_s)
    if args.out:
        np.save(args.out, est)
    kf_frames = [i for i, m in enumerate(slam.metrics)
                 if m.get("event") in ("init", "keyframe")]
    reloc = [i for i, m in enumerate(slam.metrics) if "reloc_ok" in m]
    print(json.dumps({
        "sequence": args.sequence,
        "loops": args.loops,
        "async_mapping": args.async_mapping,
        "ate_m": float(rmse),
        "frames": len(frames),
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "lost": sum(1 for m in slam.metrics if m.get("lost", False)),
        "lost_frames": [i for i, m in enumerate(slam.metrics) if m["lost"]],
        "kf_event_frames": kf_frames,
        "reloc_frames": reloc,
        "reloc_ok_frames": [i for i in reloc if slam.metrics[i]["reloc_ok"]],
        "reloc_paths": ["bow" if vocab_ready[i] else "global" for i in reloc],
        "n_loops_closed": slam.n_loops_closed,
        "loop_closed_frames": [i for i, m in enumerate(slam.metrics)
                               if m.get("event") == "loop_closed"],
        "loop_verified": [(i, m["loop_candidate"], m["loop_inliers"])
                          for i, m in enumerate(slam.metrics)
                          if "loop_inliers" in m],
        **gba,
        "seconds": time.perf_counter() - t0,
    }))


def batched() -> None:
    """``run_sequences`` over ``sequences.BATCH`` on a 4-device CPU mesh."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from boslam_tpu.config import SlamConfig
    from boslam_tpu.geometry import align
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel.multi import run_sequences, seq_mesh

    built = [sequences.build(n, SlamConfig, synthetic)
             for n in sequences.BATCH]
    cfg = built[0][0]
    assert all(b[0] == cfg for b in built)
    t0 = time.perf_counter()
    eng = run_sequences(cfg, [b[2] for b in built],
                        mesh=seq_mesh(len(built)))
    out = {}
    for s, (name, (_, traj, _)) in enumerate(zip(sequences.BATCH, built)):
        _, est = eng.trajectory(s)
        rmse, _ = align.ate_rmse(jnp.asarray(est[:, 4:]),
                                 jnp.asarray(traj.poses_twc[:, 4:]))
        out[name] = dict(ate_m=float(rmse), keyframes=eng.n_keyframes(s),
                         points=eng.n_points(s),
                         **sequences.batch_events(eng.metrics[s]))
    print(json.dumps({"batched": list(sequences.BATCH), "sequences": out,
                      "seconds": time.perf_counter() - t0}))


def ba_problem() -> None:
    """The bench's 50k-landmark global-BA problem (``bench.py:786-830``)."""
    import jax.numpy as jnp

    from boslam_tpu.config import MapConfig, OrbConfig, SlamConfig
    from boslam_tpu.geometry import se3
    from boslam_tpu.io.synthetic import synthetic_ba_problem
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    cfg = SlamConfig(map=MapConfig(max_keyframes=256, max_points=65536),
                     orb=OrbConfig(n_features=512))
    st, gt_poses, _ = synthetic_ba_problem(
        cfg, np.random.default_rng(0), n_kf=256, n_pts=50000, obs_per_kf=512)
    t0 = time.perf_counter()
    st2, stats = global_bundle_adjustment(cfg, st, lm_iters=6, cg_iters=40)
    _, terr0 = se3.pose_distance(st.kf_pose[:256], gt_poses)
    _, terr = se3.pose_distance(st2.kf_pose[:256], gt_poses)
    print(json.dumps({
        "problem": "synthetic_ba_problem(seed 0, 256 kf, 50000 pts, 512 obs)",
        "n_edges": int(stats.n_edges),
        "n_landmarks": int(jnp.sum(st.pt_valid)),
        "cost0": float(stats.cost0),
        "cost1": float(stats.cost1),
        "max_pose_err_before_m": float(jnp.max(terr0)),
        "max_pose_err_m": float(jnp.max(terr)),
        "cpu_seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
