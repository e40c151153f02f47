"""Reference-compatible command line.

Same flags as the reference binary (lmj_parseArgs,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:7989-8106):

    python -m linearsfm_tpu.cli -path DATA -num N -type {Monocular,Stereo}
                                [-st state.txt] [-p pose.txt] [-f feat.txt]

plus extensions: --method, --exec, --cpu, --quiet, --ckpt, --resume,
--trace, --check. It runs on the GPU and fails when JAX finds none, unless
--cpu asks for the CPU.
"""

from __future__ import annotations

import sys


def _print_help():
    print("Linear SFM (JAX) General Options\n")
    print("-path          Set Data Path.")
    print("-st            Set Path to Save Final State Vector")
    print("-p             Set Path to Save Poses")
    print("-f             Set Path to Save Features")
    print("-num           Number of Initial Reconstruction")
    print("-type          Set Data Type: Monocular | Stereo")
    print("--method       Solver precision: direct | refine (f32+refinement)")
    print("--exec         Tree executor: device (resident, fastest) | host |")
    print("               dense (experimental fused-level pipeline)")
    print("--cpu          Force CPU backend")
    print("--ckpt DIR     Save per-level checkpoints to DIR")
    print("--resume       Resume from the latest checkpoint in --ckpt DIR")
    print("--trace DIR    Write a jax.profiler trace to DIR")
    print("--check        Validate the solved map (finite values, block")
    print("               ranges, gauge ids); non-zero exit on problems")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"path": None, "st": None, "p": None, "f": None, "num": None,
            "type": None, "method": "direct", "cpu": False, "quiet": False,
            "ckpt": None, "resume": False, "trace": None, "exec": None,
            "check": False}
    i = 0
    while i < len(argv):
        name = argv[i].lstrip("-")
        if name == "help":
            _print_help()
            return 0
        if name in ("cpu", "quiet", "resume", "check"):
            opts[name] = True
            i += 1
            continue
        if name not in opts:
            print(f"LinearSFM Error: unknown flag -{name}")
            return 1
        i += 1
        if i >= len(argv):
            print(f"LinearSFM Error: flag -{name} needs a value")
            return 1
        opts[name] = argv[i]
        i += 1

    if not opts["path"]:
        print("LinerSFM Error: Please Input Right File Path:")
        return 1
    if not opts["num"]:
        print("LinerSFM Error: Please Set Local Map Number:")
        return 1
    if opts["type"] not in ("Monocular", "Stereo"):
        print("LinerSFM Error: Please Set Data Type:")
        return 1

    import jax
    if opts["cpu"]:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"LinearSFM Error: JAX found no GPU (backend "
              f"{jax.default_backend()!r}); pass --cpu to run on the CPU")
        return 1

    import logging
    logging.basicConfig(level=logging.WARNING if opts["quiet"] else logging.INFO,
                        format="%(message)s")

    from .core import pipeline
    datatype = "mono" if opts["type"] == "Monocular" else "stereo"
    # Default to the device-resident executor (also supports checkpoint/
    # resume via stacked level-boundary snapshots).
    executor = opts["exec"] or "device"
    final, wall = pipeline.run(
        opts["path"], int(opts["num"]), datatype,
        st_path=opts["st"], pose_path=opts["p"], feat_path=opts["f"],
        method=opts["method"], progress=not opts["quiet"],
        ckpt_dir=opts["ckpt"], resume=opts["resume"], trace_dir=opts["trace"],
        executor=executor)
    print(f"Total Used Time:  {wall:f}  sec")
    if opts["check"]:
        from .utils import debug
        probs = debug.check_map(final)
        for p in probs:
            print(f"LinearSFM Check: {p}")
        if probs:
            return 2
        print("LinearSFM Check: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
