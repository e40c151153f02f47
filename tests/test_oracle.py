"""Golden tests against the compiled reference binary.

The oracle is the UNMODIFIED reference C++ compiled with shim headers
(tools/oracle). Both consume identical synthetic datasets written in the
reference text format; outputs are compared pose-by-pose.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.join(os.path.dirname(__file__), "..")
ORACLE = os.path.join(REPO, "tools", "oracle", "linearsfm_oracle")


def _ensure_oracle():
    if not os.path.exists(ORACLE):
        r = subprocess.run([os.path.join(REPO, "tools", "oracle", "build.sh")],
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("oracle build failed: " + r.stderr.decode()[-500:])
    return ORACLE


def _run_case(tmp_path, datatype, num, noise, seed, atol, **solver_kw):
    from synth import generate as gen
    from linearsfm_tpu.core.tree import TreeSolver
    from linearsfm_tpu.core import pipeline
    from linearsfm_tpu.io import localmap as lio

    maps, poses_gt, _ = gen.make_dataset(num, datatype, noise=noise, seed=seed)
    gen.write_dataset(maps, str(tmp_path))

    oracle = _ensure_oracle()
    typ = "Stereo" if datatype == "stereo" else "Monocular"
    r = subprocess.run(
        [oracle, "-path", str(tmp_path), "-num", str(num), "-type", typ,
         "-p", str(tmp_path / "pose_ref.txt"), "-f", str(tmp_path / "feat_ref.txt")],
        capture_output=True, timeout=300)
    assert r.returncode == 0, r.stdout.decode()[-500:]

    final, _ = pipeline.run(str(tmp_path), num, datatype,
                            pose_path=str(tmp_path / "pose_jax.txt"),
                            feat_path=str(tmp_path / "feat_jax.txt"),
                            progress=False,
                            solver=TreeSolver(datatype, **solver_kw))

    ids_r, poses_r = lio.read_poses(str(tmp_path / "pose_ref.txt"))
    ids_t, poses_t = lio.read_poses(str(tmp_path / "pose_jax.txt"))
    np.testing.assert_array_equal(ids_r, ids_t)
    err = np.abs(poses_r - poses_t).max()
    assert err < atol, f"pose divergence vs oracle: {err}"

    fid_r, feats_r = lio.read_features(str(tmp_path / "feat_ref.txt"))
    fid_t, feats_t = lio.read_features(str(tmp_path / "feat_jax.txt"))
    np.testing.assert_array_equal(fid_r, fid_t)
    ferr = np.abs(feats_r - feats_t).max()
    assert ferr < atol, f"feature divergence vs oracle: {ferr}"
    return err, ferr


def test_oracle_stereo_golden(tmp_path):
    _run_case(tmp_path, "stereo", 10, 0.01, 21, atol=1e-5)


def test_oracle_stereo_larger(tmp_path):
    _run_case(tmp_path, "stereo", 17, 0.005, 22, atol=1e-5)


def test_oracle_mono_golden(tmp_path):
    # pin="zero" reproduces the reference's drop-column gauge handling exactly
    _run_case(tmp_path, "mono", 8, 0.005, 23, atol=1e-4)
