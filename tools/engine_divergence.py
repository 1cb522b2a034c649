"""Run the JAX reference engine and the port's engine (on the CPU) in
lockstep over a named sequence of ``tools/sequences.py`` and find the
first frame after which their integer state parts.

After every frame it compares the two engines' keyframe slots and
sequence numbers, keyframe observations (``kf_obs_pt``), live points, the
tracker's status and reference keyframe, and the culled keyframes, and
records the largest keyframe-pose difference.  At the first frame where an
integer field differs it replays that frame's step on the reference's
state from just before it, in both packages (the JAX ``frame_step_core``
and the port's), compares the frame's features, and replays the port's
step once more with the reference's features handed to it: if that one
agrees with the reference, the engines parted through the features' float
rounding, not through a step that decides differently on the same input.

    JAX_PLATFORMS=cpu python tools/engine_divergence.py [--sequence loop]
        [--loops] [--jax-pyramid]

``--jax-pyramid`` hands the port the reference's image pyramid (levels 1+
from ``jax.image.resize``), as the CPU tests hand it JAX's RANSAC noise:
the resize's float sums are XLA's own and the port's replica rounds some
pixels an ulp apart.

Prints one JSON line per 16 frames (the largest pose difference so far)
and one for the first divergence with the replay's verdict, or one saying
that none was found, with the loops each engine closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

import sequences  # noqa: E402

FIELDS = ("kf_valid", "kf_seq", "kf_obs_pt", "pt_valid", "n_kf")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="loop")
    ap.add_argument("--loops", action="store_true",
                    help="verify and close loops (MAX_VERIFY stays 4)")
    ap.add_argument("--jax-pyramid", action="store_true",
                    help="hand the port the reference's pyramid levels")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from boslam_tpu import slam as j_slam
    from boslam_tpu.config import SlamConfig as JaxConfig
    from boslam_tpu.features import extract_features as j_features
    from boslam_tpu.io import synthetic as j_synthetic
    from boslam_tpu_torch import convert
    from boslam_tpu_torch import slam as t_slam
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.tracking.tracker import HostSync

    if args.jax_pyramid:
        from boslam_tpu_torch.features import frontend as t_frontend

        def jax_pyramid(gray, cfg):
            shapes = t_frontend.pyramid_shapes(
                cfg.camera.height, cfg.camera.width, cfg.orb.n_levels,
                cfg.orb.scale_factor)
            levels = [jnp.asarray(gray.numpy())]
            for hl, wl in shapes[1:]:
                levels.append(jax.image.resize(levels[-1], (hl, wl), "linear"))
            return [gray] + [torch.from_numpy(np.array(v)) for v in levels[1:]]

        t_frontend.build_pyramid = jax_pyramid

    cfg_j, _, frames = sequences.build(args.sequence, JaxConfig, j_synthetic)
    cfg_t = SlamConfig.from_dict(sequences.SEQUENCES[args.sequence]["cfg"])
    ref = j_slam.SlamSystem(cfg_j)
    port = t_slam.SlamSystem(cfg_t, device="cpu")
    if not args.loops:
        ref.MAX_VERIFY = port.MAX_VERIFY = 0

    def np_state(nt):
        return {k: np.array(v) for k, v in nt._asdict().items()}

    def port_np(nt):
        return {k: v.numpy() for k, v in nt._asdict().items()}

    def differing(a, b):
        return [k for k in FIELDS if not np.array_equal(a[k], b[k])]

    pose_diff = 0.0
    for i, (ts, rgb, depth) in enumerate(frames):
        # Copies: the reference's step donates its input buffers.
        before = (np_state(ref.map), np_state(ref.loop), np_state(ref.track),
                  np.array(jax.random.key_data(ref.key)))
        ref.feed(ts, rgb, depth)
        port.feed(ts, rgb, depth)
        a, b = np_state(ref.map), port_np(port.map)
        valid = a["kf_valid"] & b["kf_valid"]
        if valid.any():
            pose_diff = max(pose_diff, float(np.abs(
                a["kf_pose"][valid] - b["kf_pose"][valid]).max()))
        diff = differing(a, b)
        ta, tb = np_state(ref.track), port_np(port.track)
        for k in ("status", "last_kf"):
            if not np.array_equal(ta[k], tb[k]):
                diff.append(f"track.{k}")
        if set(ref.cull_chain) != set(port.cull_chain):
            diff.append("cull_chain")
        if i % 16 == 15:
            print(json.dumps(dict(frame=i, max_kf_pose_diff=pose_diff)),
                  flush=True)
        if not diff:
            continue

        # Replay frame i's step on the reference's state from before it.
        m0, l0, t0, key = before
        img = t_slam.to_gray_u8(rgb)
        d16 = t_slam.depth_wire(depth, cfg_t.camera)
        jm, _, jt, _, jrow = j_slam.frame_step_core(
            cfg_j, type(ref.map)(**{k: jnp.asarray(v) for k, v in m0.items()}),
            type(ref.loop)(**{k: jnp.asarray(v) for k, v in l0.items()}),
            type(ref.track)(**{k: jnp.asarray(v) for k, v in t0.items()}),
            jax.random.wrap_key_data(jnp.asarray(key)), jnp.asarray(img),
            jnp.asarray(d16), True)
        pm, _, pt, prow = t_slam.frame_step_core(
            cfg_t, convert.map_state_from_numpy(m0, "cpu"),
            convert.loop_state_from_numpy(l0, "cpu"),
            convert.track_state_from_numpy(t0, "cpu"),
            torch.Generator().manual_seed(0), torch.from_numpy(img),
            torch.from_numpy(d16), HostSync())
        replay = differing(np_state(jm), port_np(pm))
        jrow, prow = np.asarray(jrow), prow.numpy()
        # The frame's features in both packages, and the port's step again
        # with the reference's features handed to it.
        gray = img.astype(np.float32)
        depth_m = d16.astype(np.float32) * np.float32(
            1.0 / cfg_t.camera.depth_factor)
        fj = j_features(jnp.asarray(gray), jnp.asarray(depth_m), cfg_j)
        ft = t_slam.extract_features(torch.from_numpy(gray),
                                     torch.from_numpy(depth_m), cfg_t)
        fa, fb = np_state(fj), port_np(ft)
        uv_diff = np.abs(fa["uv"] - fb["uv"]).max(-1)
        feats = dict(
            keypoints_moved=int((uv_diff > 0).sum()),
            max_uv_diff_px=float(uv_diff.max()),
            max_angle_diff=float(np.abs(fa["angle"] - fb["angle"]).max()),
            desc_words_differing=int((fa["desc"] != fb["desc"].view(
                np.uint32)).sum()),
            octaves_of_moved=sorted(set(fa["octave"][uv_diff > 0].tolist())))
        extract = t_slam.extract_features
        t_slam.extract_features = (
            lambda *_: convert.frame_features_from_numpy(fa, "cpu"))
        try:
            pm2, _, _, _ = t_slam.frame_step_core(
                cfg_t, convert.map_state_from_numpy(m0, "cpu"),
                convert.loop_state_from_numpy(l0, "cpu"),
                convert.track_state_from_numpy(t0, "cpu"),
                torch.Generator().manual_seed(0), torch.from_numpy(img),
                torch.from_numpy(d16), HostSync())
        finally:
            t_slam.extract_features = extract
        replay_ref_feats = differing(np_state(jm), port_np(pm2))
        print(json.dumps(dict(
            first_divergence_frame=i, flush_frame=(i % port.chunk
                                                   == port.chunk - 1),
            fields=diff, max_kf_pose_diff=pose_diff,
            features=feats,
            replay_fields_differing=replay,
            replay_with_reference_features_fields_differing=replay_ref_feats,
            replay_rows_max_diff=float(np.abs(jrow - prow).max()),
            replay_ref_row_cull=jrow[t_slam.O_CULL0:t_slam.O_CULL0 + 2].tolist(),
            replay_port_row_cull=prow[t_slam.O_CULL0:t_slam.O_CULL0 + 2].tolist(),
        )), flush=True)
        return
    ref.trajectory()
    port.trajectory()
    print(json.dumps(dict(
        first_divergence_frame=None, max_kf_pose_diff=pose_diff,
        loop_closed_frames=[[i for i, m in enumerate(e.metrics)
                             if m.get("event") == "loop_closed"]
                            for e in (ref, port)])), flush=True)


if __name__ == "__main__":
    main()
