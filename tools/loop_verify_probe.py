"""Replay the JAX reference's loop verifications through the port, and
set both engines' own verifications side by side.

Runs the JAX engine (loops on) over a named sequence of
``tools/sequences.py`` and keeps, at every verification batch it
dispatches, its map state, its RANSAC key and its own results.  Each batch
then goes through the port's ``verify_loops_batch`` on that same state on
the CPU twice: with the reference's own Gumbel noise, and with noise drawn
from a ``torch.Generator`` (as the port's engine draws it).  Where the
first agrees with the reference and the second does not, the outcome is
RANSAC's random stream, which the two packages cannot share; where the
first disagrees, the port's verification differs.

Then it runs the port's engine on the CPU over the same frames and prints,
for every request either engine resolved, whether its endpoints were still
the same keyframes (``fresh``), its decision and its inliers, and each
engine's culled keyframes (slot, seq) in order.

    JAX_PLATFORMS=cpu python tools/loop_verify_probe.py [--sequence loop]
        [--seed 0]

Prints one JSON line per verification request of the reference (frame,
keyframe slot, candidate, and (ok, inliers) for the reference, the port
on the reference's noise and the port on its own noise), a summary line,
then one line per resolved request of each engine and one with the culls.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="loop")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engines' seed (the RANSAC draws)")
    args = ap.parse_args()

    import jax
    import torch

    from boslam_tpu.config import SlamConfig as JaxConfig
    from boslam_tpu.io import synthetic as j_synthetic
    from boslam_tpu.slam import SlamSystem as JaxSlam
    from boslam_tpu_torch import convert
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.loopclosure import verify_loops_batch

    cfg_j, _, frames = sequences.build(args.sequence, JaxConfig, j_synthetic)
    cfg_t = SlamConfig.from_dict(sequences.SEQUENCES[args.sequence]["cfg"])
    batches = []

    def resolved_log(cls):
        """A subclass of engine class ``cls`` that logs, at every resolve,
        each request's frame, slots, freshness, decision and inliers."""

        class Logged(cls):
            log = []

            def _resolve_pending_verify(self):
                pv = self._pending_verify
                if pv is not None:
                    ok, _, n_inl, _, _, reqs, guards = pv[:7]
                    ok, n_inl = np.asarray(ok), np.asarray(n_inl)
                    frame = {id(m): i for i, m in enumerate(self.metrics)}
                    for i, (kf, cand, rec) in enumerate(reqs):
                        fresh = (guards[i][0] is not None
                                 and guards[i][1] is not None
                                 and self._kf_seq_host.get(kf) == guards[i][0]
                                 and self._kf_seq_host.get(cand) == guards[i][1])
                        self.log.append(dict(
                            frame=frame[id(rec)], kf=kf, cand=cand,
                            fresh=bool(fresh), ok=bool(ok[i]),
                            inliers=int(n_inl[i])))
                super()._resolve_pending_verify()
        return Logged

    class Capture(resolved_log(JaxSlam)):
        def _dispatch_verify(self, loop_requests):
            key = self.key
            super()._dispatch_verify(loop_requests)
            if self._pending_verify is None:
                return
            ok, _, n_inl, _, _, reqs = self._pending_verify[:6]
            frame = {id(m): i for i, m in enumerate(self.metrics)}
            batches.append(dict(
                map={k: np.asarray(v) for k, v in self.map._asdict().items()},
                key=key,
                reqs=[(frame[id(rec)], kf, cand) for kf, cand, rec in reqs],
                ok=np.asarray(ok), n_inl=np.asarray(n_inl)))

    slam = Capture(cfg_j, seed=args.seed)
    for f in frames:
        slam.feed(*f)
    slam.trajectory()
    closed = [i for i, m in enumerate(slam.metrics)
              if m.get("event") == "loop_closed"]

    B = slam.MAX_VERIFY
    shape = (cfg_t.tracker.ransac_iters, cfg_t.orb.n_features)
    gen = torch.Generator().manual_seed(args.seed)
    n_same_noise = n_own_noise = n_req = 0
    for b in batches:
        state = convert.map_state_from_numpy(b["map"], "cpu")
        pad = b["reqs"] + [b["reqs"][0]] * (B - len(b["reqs"]))
        kf_ids = torch.tensor([r[1] for r in pad], dtype=torch.int32)
        cands = torch.tensor([r[2] for r in pad], dtype=torch.int32)
        # The reference's draws: its key split once, then per request.
        keys = jax.random.split(jax.random.split(b["key"])[1], B)
        noise = torch.from_numpy(np.stack(
            [np.array(jax.random.gumbel(k, shape)) for k in keys]))
        ok_a, _, inl_a, _, _ = verify_loops_batch(cfg_t, state, kf_ids, cands,
                                                  noise)
        ok_b, _, inl_b, _, _ = verify_loops_batch(cfg_t, state, kf_ids, cands,
                                                  gen)
        for i, (frame, kf, cand) in enumerate(b["reqs"]):
            ref = (bool(b["ok"][i]), int(b["n_inl"][i]))
            same = (bool(ok_a[i]), int(inl_a[i]))
            own = (bool(ok_b[i]), int(inl_b[i]))
            n_req += 1
            n_same_noise += same[0] == ref[0]
            n_own_noise += own[0] == ref[0]
            print(json.dumps(dict(frame=frame, kf=kf, cand=cand, reference=ref,
                                  port_reference_noise=same,
                                  port_own_noise=own)), flush=True)
    print(json.dumps(dict(
        sequence=args.sequence, reference_loop_closed_frames=closed,
        requests=n_req, decisions_equal_on_reference_noise=n_same_noise,
        decisions_equal_on_own_noise=n_own_noise)), flush=True)

    # The port's own engine on the same frames (its own RANSAC draws).
    from boslam_tpu_torch.io import synthetic as t_synthetic
    from boslam_tpu_torch.slam import SlamSystem

    _, _, frames_t = sequences.build(args.sequence, SlamConfig, t_synthetic)
    port = resolved_log(SlamSystem)(cfg_t, seed=args.seed, device="cpu")
    for f in frames_t:
        port.feed(*f)
    port.trajectory()
    for name, eng in (("reference", slam), ("port", port)):
        for r in eng.log:
            print(json.dumps(dict(engine=name, **r)), flush=True)
    print(json.dumps(dict(
        reference_culls=sorted(slam.cull_chain, key=lambda k: k[1]),
        port_culls=sorted(port.cull_chain, key=lambda k: k[1]),
        reference_loop_closed_frames=closed,
        port_loop_closed_frames=[i for i, m in enumerate(port.metrics)
                                 if m.get("event") == "loop_closed"])),
          flush=True)


if __name__ == "__main__":
    main()
