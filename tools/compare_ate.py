"""ATE comparison: this pipeline vs the reference oracle on a shared dataset.

Usage: python tools/compare_ate.py --num 128 --type stereo [--noise 0.005]
Runs both on freshly generated data and reports max/RMS pose differences and
each one's error vs ground truth.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--type", choices=["stereo", "mono"], default="stereo")
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pattern", default="loop")
    ap.add_argument("--exec", dest="executor", default="device",
                    help="tree executor (production default: device)")
    ap.add_argument("--method", default="refine",
                    help="solver method (production default: refine)")
    ap.add_argument("--covis", action="store_true",
                    help="loop-closure co-visibility (radius 6, max 6 — the "
                         "bench/baseline dataset family)")
    ap.add_argument("--json", default=None,
                    help="write the comparison record to this path")
    ap.add_argument("--dir", default=None,
                    help="persistent working dir (default: fresh tempdir)")
    ap.add_argument("--phase", choices=["both", "oracle", "solve"],
                    default="both",
                    help="'oracle': generate data + run the reference only "
                         "(background-friendly, records timing in "
                         "DIR/oracle_meta.json); 'solve': reuse DIR from a "
                         "previous oracle phase and run/compare this solver")
    args = ap.parse_args()

    import json

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from synth import generate as gen
    from linearsfm_tpu.io import localmap as lio

    d = args.dir or tempfile.mkdtemp(prefix="ate_")
    os.makedirs(d, exist_ok=True)
    meta_path = os.path.join(d, "oracle_meta.json")

    if args.phase in ("both", "oracle"):
        cov = dict(covis_radius=6.0, covis_max=6) if args.covis else {}
        maps, poses_gt, _ = gen.make_dataset(args.num, args.type,
                                             noise=args.noise, seed=args.seed,
                                             pattern=args.pattern, **cov)
        gen.write_dataset(maps, d)
        np.save(os.path.join(d, "poses_gt.npy"), poses_gt)

        oracle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "oracle", "linearsfm_oracle")
        typ = "Stereo" if args.type == "stereo" else "Monocular"
        t0 = time.time()
        r = subprocess.run([oracle, "-path", d, "-num", str(args.num),
                            "-type", typ, "-p", d + "/pose_ref.txt",
                            "-f", d + "/feat_ref.txt"],
                           check=True, capture_output=True, timeout=7200)
        t_oracle = time.time() - t0
        import re
        m = re.search(r"Total Used Time:\s*([0-9.]+)", r.stdout.decode())
        with open(meta_path, "w") as fh:
            json.dump(dict(num=args.num, type=args.type, noise=args.noise,
                           seed=args.seed, covis=bool(args.covis),
                           pattern=args.pattern, oracle_wall_s=t_oracle,
                           oracle_solve_s=float(m.group(1)) if m else None),
                      fh, indent=1)
        if args.phase == "oracle":
            print(f"oracle phase done: wall {t_oracle:.2f}s -> {meta_path}")
            return
    else:
        with open(meta_path) as fh:
            meta = json.load(fh)
        for k in ("num", "type", "covis", "pattern"):
            got = getattr(args, "covis" if k == "covis" else k)
            want = meta[k]
            assert got == want, f"--{k}={got} mismatches oracle dir ({want})"
        t_oracle = meta["oracle_wall_s"]

    poses_gt = np.load(os.path.join(d, "poses_gt.npy"))
    from linearsfm_tpu.core import pipeline
    final, t_jax = pipeline.run(d, args.num, args.type,
                                pose_path=d + "/pose_jax.txt",
                                feat_path=d + "/feat_jax.txt", progress=False,
                                executor=args.executor, method=args.method)

    ids_r, pr = lio.read_poses(d + "/pose_ref.txt")
    ids_t, pt = lio.read_poses(d + "/pose_jax.txt")
    assert (ids_r == ids_t).all()
    d_ref = np.abs(pr - pt)
    def ate(p, ids):
        errs = [np.linalg.norm(p[i, :3] - poses_gt[int(ids[i]), :3])
                for i in range(len(ids))]
        return float(np.sqrt(np.mean(np.square(errs))))
    print(f"maps={args.num} type={args.type} noise={args.noise} "
          f"covis={args.covis}")
    print(f"oracle wall: {t_oracle:.2f}s   jax wall: {t_jax:.2f}s")
    print(f"pose diff vs oracle: max {d_ref.max():.3e}  rms {np.sqrt((d_ref**2).mean()):.3e}")
    print(f"ATE vs gt: oracle {ate(pr, ids_r):.4f}  jax {ate(pt, ids_t):.4f}")
    if args.json:
        rec = dict(num=args.num, type=args.type, noise=args.noise,
                   seed=args.seed, covis=bool(args.covis),
                   oracle_wall_s=round(t_oracle, 3),
                   jax_wall_s=round(t_jax, 3),
                   pose_diff_max=float(d_ref.max()),
                   pose_diff_rms=float(np.sqrt((d_ref ** 2).mean())),
                   ate_oracle=ate(pr, ids_r), ate_jax=ate(pt, ids_t))
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
