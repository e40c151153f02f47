"""On-card smoke test of the device-resident merge tree.

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --devices 4   # four GPUs: the dp/tp mesh phase only

Default phases, in order; any failure exits non-zero, none is passed over:

1. device: JAX's default backend is the GPU; prints the card's name and
   power limit (nvidia-smi), its JAX device kind and the JAX versions.
2. densify at root width: ops/schur.densify_blocks at the entry count and
   sizes of the 2,048-map stereo root join, both block shapes, against a
   float64 NumPy accumulation; beside it a window-scatter form, for the
   compile and run times of both.
3. stereo, 2,048 maps (bench.py's dataset): the CLI (f64 dense Cholesky,
   --check) and the in-process f32-preconditioned f64 PCG; ATE against the
   compiled reference's, the two solves against each other.
4. mono, 466 maps (the reference's RS468 map count): the CLI with --check
   and ATE against the compiled reference's.
5. GPU against CPU, same code: 64-map stereo and mono, both methods; the CPU
   side runs in a JAX_PLATFORMS=cpu subprocess, which never opens the card.

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's dataset family: synthetic loop with loop-closure co-visibility.
DATA = dict(noise=0.005, seed=7, covis_radius=6.0, covis_max=6)

# ATE against ground truth of the compiled reference (tools/oracle, the
# single-threaded C++/CHOLMOD binary) on exactly these datasets, from its
# printed poses: 2,048-map stereo from `tools/compare_ate.py --num 2048
# --covis` (ate_oracle), 466-map mono from `tools/compare_ate.py --num 466
# --type mono --covis --phase oracle`.
ATE_ORACLE = {("stereo", 2048): 0.009758730429278021,
              ("mono", 466): 0.014063692587672328}
# Printed poses differ from the reference's by at most ~1e-6 (%f output);
# ATE over thousands of poses moves far less than that.
ATE_TOL = 1e-5

# f32 sums over duplicate entries, reduced in another order than NumPy's.
DENSIFY_RTOL = 1e-5
# Two independent precision designs on the same data: f64 dense Cholesky
# against the f32-preconditioned f64 PCG.
DIRECT_VS_REFINE_TOL = 1e-6
REFINE_RES_MAX = 1e-10
# Same code on GPU and CPU. direct: only the f64 summation order differs;
# mono's scale-pinned systems are worse conditioned and amplify it more
# (measured on an H100 80GB HBM3 at 700 W: stereo 1.2e-12, mono 1.4e-09, so
# mono's bound is 1e-8). refine: the f32 preconditioner differs too; PCG
# exits at a relative residual of 1e-14, so the answers agree to what that
# leaves.
GPU_VS_CPU_TOL = {("stereo", "direct"): 1e-9, ("mono", "direct"): 1e-8,
                  ("stereo", "refine"): 1e-7, ("mono", "refine"): 1e-7}
# 4-GPU mesh against one GPU (refine): scatter-add, segment_sum and the tp
# root's psum of partial Schur systems reduce in unspecified orders, which
# moves the f32 preconditioner; the f64 PCG converges to the same answer.
# The tp solve must work on one copy of its replicated operands
# (parallel/shard_solve.py); without that, 4 H100s differed from one by
# 5.7e-06 here.
MESH_TOL = 1e-7


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(msg, flush=True)


# -- phase 1 -----------------------------------------------------------------

def phase_device(ndev: int) -> str:
    import jax
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX found no GPU (default backend {backend!r})")
    check(len(jax.devices()) >= ndev,
          f"{ndev} GPUs asked for, JAX sees {len(jax.devices())}")
    check(os.path.isdir(os.path.join(HERE, "linearsfm_tpu")),
          f"no linearsfm_tpu package beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in smi.splitlines() if ln.strip()]
    check(lines, "nvidia-smi printed no card")
    for ln in lines:
        say(ln)
    import jaxlib
    say(f"device_kind: {jax.devices()[0].device_kind} "
        f"x{len(jax.devices())}; jax {jax.__version__}, "
        f"jaxlib {jaxlib.__version__}")
    return lines[0]


# -- phase 2 -----------------------------------------------------------------

def densify_windows(rows, cols, vals, M: int, N: int):
    """Window-scatter form of ops/schur.densify_blocks: one [R, C] window
    per block instead of R*C scalar updates (the measured alternative)."""
    import jax.numpy as jnp
    from jax import lax
    K, R, C = vals.shape
    idx = jnp.stack([jnp.where(rows >= 0, rows * R, R * M), cols * C],
                    axis=1)
    dn = lax.ScatterDimensionNumbers(update_window_dims=(1, 2),
                                     inserted_window_dims=(),
                                     scatter_dims_to_operand_dims=(0, 1))
    return lax.scatter_add(jnp.zeros((R * M, C * N), vals.dtype), idx, vals,
                           dn, mode=lax.GatherScatterMode.FILL_OR_DROP)


def _root_join_sizes(maps, datatype):
    """(M, N, KU, KW) of the root join's merged system, from the exact plan
    the device executor itself builds."""
    from linearsfm_tpu.core import compact as compact_mod
    from linearsfm_tpu.core import plan as plan_mod
    from linearsfm_tpu.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu.utils import flops
    s = DeviceTreeSolver(datatype)
    st = compact_mod.compact_stack([m.to_local_map() for m in maps],
                                   s.bucket, s.u_bucket)
    tp = plan_mod.plan_tree_exact(plan_mod.sym_of_stacked(st), datatype,
                                  s.bucket, s.u_bucket)
    return flops.merged_caps(tp.levels[-1].caps_in, datatype)


def _block_coo(rng, R, C, M, N, K):
    """Row-sorted block list like a join's, with duplicates and -1 pads."""
    rows = rng.integers(0, M, K).astype(np.int32)
    cols = rng.integers(0, N, K).astype(np.int32)
    d = K // 8
    rows[K // 2:K // 2 + d], cols[K // 2:K // 2 + d] = rows[:d], cols[:d]
    rows[::16] = -1
    order = np.argsort(rows, kind="stable")
    vals = rng.standard_normal((K, R, C)).astype(np.float32)
    return rows[order], cols[order], vals[order]


def _dense_ref(rows, cols, vals, M, N):
    K, R, C = vals.shape
    keep = rows >= 0
    r = (rows[keep, None, None] * R + np.arange(R)[None, :, None])
    c = (cols[keep, None, None] * C + np.arange(C)[None, None, :])
    flat = (r.astype(np.int64) * (C * N) + c).reshape(-1)
    return np.bincount(flat, weights=vals[keep].astype(np.float64).ravel(),
                       minlength=R * M * C * N).reshape(R * M, C * N)


def phase_densify(card: str, maps) -> None:
    import jax
    from linearsfm_tpu.ops import schur
    M, N, KU, KW = _root_join_sizes(maps, "stereo")
    say(f"root join: M={M} poses, N={N} features, {KU} U blocks, "
        f"{KW} W blocks")
    rng = np.random.default_rng(0)
    for R, C, Mo, No, K in ((6, 3, M, N, KW), (6, 6, M, M, KU)):
        rows, cols, vals = _block_coo(rng, R, C, Mo, No, K)
        ref = _dense_ref(rows, cols, vals, Mo, No)
        scale = np.abs(ref).max()
        args = tuple(jax.device_put(a) for a in (rows, cols, vals))
        for name, fn in (("element .at[].add", schur.densify_blocks),
                         ("window scatter_add", densify_windows)):
            t0 = time.perf_counter()
            exe = jax.jit(fn, static_argnums=(3, 4)).lower(
                *args, Mo, No).compile()
            t_compile = time.perf_counter() - t0
            out = exe(*args).block_until_ready()
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                exe(*args).block_until_ready()
                runs.append(time.perf_counter() - t0)
            err = float(np.abs(np.asarray(out, np.float64) - ref).max())
            say(f"densify ({R},{C}) {name}: {K} blocks -> "
                f"[{R * Mo}, {C * No}] f32, compile {t_compile:.3f} s, "
                f"run {1e3 * min(runs):.3f} ms (best of 3), max|diff| "
                f"{err:.3e} vs max|ref| {scale:.3e} [{card}]")
            check(err <= DENSIFY_RTOL * scale,
                  f"densify ({R},{C}) {name}: max|diff| {err:.3e} > "
                  f"{DENSIFY_RTOL} x {scale:.3e}")
            del out


# -- phases 3 and 4 ------------------------------------------------------------

def _ate(ids, poses, poses_gt) -> float:
    ids = np.asarray(ids)
    keep = ids >= 0
    err = np.linalg.norm(np.asarray(poses)[keep, :3]
                         - poses_gt[ids[keep], :3], axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def _check_ate(what, ate, key):
    ref = ATE_ORACLE[key]
    say(f"{what}: ATE {ate:.9f} (compiled reference {ref:.9f})")
    check(abs(ate - ref) <= ATE_TOL,
          f"{what}: ATE {ate} differs from the reference's {ref} by more "
          f"than {ATE_TOL}")


def _by_id(lm):
    ids = np.asarray(lm.pose_ids)
    keep = ids >= 0
    order = np.argsort(ids[keep])
    return ids[keep][order], np.asarray(lm.poses)[keep][order]


def solve_timed(card, datatype, method, lms, label):
    """Cold run (compile + first execution), then one warm timed run.
    Returns (final map, max per-level PCG residual or None)."""
    import jax
    from linearsfm_tpu.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu.utils.metrics import LevelMetrics
    solver = DeviceTreeSolver(datatype, method=method)
    t0 = time.perf_counter()
    first = solver.run(lms)
    jax.block_until_ready(first.poses)
    cold = time.perf_counter() - t0
    compile_s = solver._last_timing["warm"]
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    final = solver.run(lms, metrics=metrics)
    jax.block_until_ready(final.poses)
    warm = time.perf_counter() - t0
    joins = len(lms) - 1
    say(f"{label} {method}: cold first run {cold:.2f} s (compile "
        f"{compile_s:.2f} s), warm run {warm:.3f} s = "
        f"{joins / warm:.2f} maps-joined/s [{card}]")
    rs = [r["res_max"] for r in metrics.records if "res_max" in r]
    ids, poses = _by_id(final)
    check(np.isfinite(poses).all(), f"{label} {method}: non-finite poses")
    # Scatter-add and segment_sum reduce in an unspecified order on the GPU,
    # so two runs of one program need not agree bit for bit.
    say(f"{label} {method}: first vs warm run pose max|diff| "
        f"{float(np.abs(_by_id(first)[1] - poses).max()):.3e}")
    return final, (max(rs) if rs else None)


def run_cli(card, d, num, typ, label) -> str:
    from linearsfm_tpu import cli
    pose = os.path.join(d, "pose.txt")
    t0 = time.perf_counter()
    rc = cli.main(["-path", d, "-num", str(num), "-type", typ, "-p", pose,
                   "--check", "--quiet"])
    say(f"{label} CLI -type {typ} --check: exit {rc}, "
        f"{time.perf_counter() - t0:.2f} s incl. reading {num} maps "
        f"[{card}]")
    check(rc == 0, f"{label} CLI exited {rc}")
    return pose


def phase_stereo(card: str, maps, poses_gt, tmp: str) -> None:
    from linearsfm_tpu.io import localmap as lio
    from synth import generate as gen
    num = len(maps)
    label = f"stereo {num}"
    lms = [m.to_local_map() for m in maps]
    direct, _ = solve_timed(card, "stereo", "direct", lms, label)
    d = os.path.join(tmp, "stereo")
    gen.write_dataset(maps, d)
    ids, poses = lio.read_poses(run_cli(card, d, num, "Stereo", label))
    _check_ate(f"{label} CLI", _ate(ids, poses, poses_gt), ("stereo", num))
    refine, res_max = solve_timed(card, "stereo", "refine", lms, label)
    _check_ate(f"{label} refine", _ate(refine.pose_ids, refine.poses,
                                       poses_gt), ("stereo", num))
    say(f"{label} refine: max per-level PCG residual {res_max:.3e}")
    check(res_max is not None and res_max <= REFINE_RES_MAX,
          f"{label} refine: residual {res_max} > {REFINE_RES_MAX}")
    (ia, pa), (ib, pb) = _by_id(direct), _by_id(refine)
    check(np.array_equal(ia, ib), f"{label}: pose ids differ")
    diff = float(np.abs(pa - pb).max())
    say(f"{label}: direct vs refine pose max|diff| {diff:.3e}")
    check(diff <= DIRECT_VS_REFINE_TOL,
          f"{label}: direct vs refine {diff:.3e} > {DIRECT_VS_REFINE_TOL}")


def phase_mono(card: str, maps, poses_gt, tmp: str) -> None:
    from linearsfm_tpu.io import localmap as lio
    from synth import generate as gen
    num = len(maps)
    label = f"mono {num}"
    direct, _ = solve_timed(card, "mono", "direct",
                            [m.to_local_map() for m in maps], label)
    _check_ate(f"{label} direct", _ate(direct.pose_ids, direct.poses,
                                       poses_gt), ("mono", num))
    d = os.path.join(tmp, "mono")
    gen.write_dataset(maps, d)
    ids, poses = lio.read_poses(run_cli(card, d, num, "Monocular", label))
    _check_ate(f"{label} CLI", _ate(ids, poses, poses_gt), ("mono", num))


# -- phase 5 -----------------------------------------------------------------

PARITY_CASES = [(t, m) for t in ("stereo", "mono")
                for m in ("direct", "refine")]
PARITY_MAPS = 64


def parity_solves() -> dict:
    """Poses of every PARITY_CASES solve on JAX's default backend."""
    from synth import generate as gen
    from linearsfm_tpu.core.device_tree import DeviceTreeSolver
    out = {}
    for typ, method in PARITY_CASES:
        maps, _, _ = gen.make_dataset(PARITY_MAPS, typ, **DATA)
        final = DeviceTreeSolver(typ, method=method).run(
            [m.to_local_map() for m in maps])
        out[f"{typ}_{method}_ids"], out[f"{typ}_{method}"] = _by_id(final)
    return out


def cpu_reference(path: str) -> None:
    """Entry of the CPU subprocess of phase 5."""
    import jax
    assert jax.default_backend() == "cpu", jax.default_backend()
    np.savez(path, **parity_solves())


def phase_parity(card: str, tmp: str) -> None:
    path = os.path.join(tmp, "cpu_parity.npz")
    # No persistent cache on the CPU side: XLA:CPU entries are keyed without
    # the host's machine features, and the subprocess shares no programs.
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.cpu_reference({path!r})"],
        cwd=HERE, env=env)
    try:
        gpu = parity_solves()
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    say(f"CPU reference subprocess: exit {rc} after "
        f"{time.perf_counter() - t0:.1f} s")
    check(rc == 0, f"CPU reference subprocess exited {rc}")
    cpu = np.load(path)
    for typ, method in PARITY_CASES:
        k = f"{typ}_{method}"
        check(np.array_equal(gpu[k + "_ids"], cpu[k + "_ids"]),
              f"{k}: pose ids differ between GPU and CPU")
        diff = float(np.abs(gpu[k] - cpu[k]).max())
        tol = GPU_VS_CPU_TOL[typ, method]
        say(f"{PARITY_MAPS}-map {typ} {method}: GPU vs CPU pose max|diff| "
            f"{diff:.3e} (bound {tol:.0e}) [{card}]")
        check(diff <= tol, f"{k}: GPU vs CPU {diff:.3e} > {tol}")


# -- --devices 4 -------------------------------------------------------------

def phase_mesh(card: str, maps) -> None:
    import jax
    from linearsfm_tpu.core import compact as compact_mod
    from linearsfm_tpu.core import plan as plan_mod
    from linearsfm_tpu.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu.parallel import mesh as mesh_mod
    lms = [m.to_local_map() for m in maps]
    nd = len(jax.devices())
    mesh_solver = mesh_mod.auto_solver("stereo")
    st = compact_mod.compact_stack(lms, mesh_solver.bucket,
                                   mesh_solver.u_bucket)
    tp = plan_mod.plan_tree_exact(plan_mod.sym_of_stacked(st), "stereo",
                                  mesh_solver.bucket, mesh_solver.u_bucket)
    modes = mesh_solver._plan_modes(tp)
    say(f"mesh over {nd} GPUs, level modes: {modes}")
    check("dp" in modes and "tp" in modes,
          f"the mesh engages {modes}, not both dp and tp")
    results = {}
    for label, solver in ((f"{nd} GPUs", mesh_solver),
                          ("1 GPU", DeviceTreeSolver("stereo"))):
        t0 = time.perf_counter()
        jax.block_until_ready(solver.run(lms).poses)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        final = solver.run(lms)
        jax.block_until_ready(final.poses)
        warm = time.perf_counter() - t0
        root_res = float(np.max(solver.last_residuals[len(tp.levels)]))
        say(f"stereo {len(lms)} refine on {label}: cold first run "
            f"{cold:.2f} s, warm run {warm:.3f} s = "
            f"{(len(lms) - 1) / warm:.2f} maps-joined/s, root PCG residual "
            f"{root_res:.3e} [{card}]")
        results[label] = _by_id(final)
    (ia, pa), (ib, pb) = results.values()
    check(np.array_equal(ia, ib), "mesh vs single GPU: pose ids differ")
    diff = float(np.abs(pa - pb).max())
    say(f"mesh vs single GPU: pose max|diff| {diff:.3e} (bound "
        f"{MESH_TOL:.0e})")
    check(np.isfinite(pa).all() and diff <= MESH_TOL,
          f"mesh vs single GPU: {diff:.3e} > {MESH_TOL}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-GPU dp/tp mesh phase")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        card = phase_device(args.devices)
        from synth import generate as gen
        stereo, stereo_gt, _ = gen.make_dataset(2048, "stereo", **DATA)
        if args.devices == 4:
            phase_mesh(card, stereo)
        else:
            phase_densify(card, stereo)
            with tempfile.TemporaryDirectory() as tmp:
                phase_stereo(card, stereo, stereo_gt, tmp)
                mono, mono_gt, _ = gen.make_dataset(466, "mono", **DATA)
                phase_mono(card, mono, mono_gt, tmp)
                phase_parity(card, tmp)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    import jax
    dev = jax.devices()[0]
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"[{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
