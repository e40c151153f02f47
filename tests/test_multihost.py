"""Multi-host tree execution: host-local subtrees + replicated top levels.

Asserts the multi-host decomposition (parallel/multihost.py) reproduces the
single-process solve — first in-process (transport stubbed), then with REAL
jax.distributed two-process CPU execution and a process_allgather over the
coordination service.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import helpers as H  # noqa: F401
from synth import generate as gen
from linearsfm_tpu.core.device_tree import DeviceTreeSolver
from linearsfm_tpu.parallel import multihost as MH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(n=8, datatype="stereo"):
    maps, poses_gt, _ = gen.make_dataset(n, datatype, noise=0.01, seed=3,
                                         covis_radius=3.0, covis_max=4)
    return [m.to_local_map() for m in maps], poses_gt


def _poses_by_id(final):
    ids = np.asarray(final.pose_ids)
    poses = np.asarray(final.poses)
    return {int(i): poses[k] for k, i in enumerate(ids) if i >= 0}


def _run_simulated(lms, datatype, n_hosts, kw):
    """Single-process simulation: every host's local phase computed in-line,
    the gather stubbed with the per-host stacked contributions."""
    stacks = [MH.local_stacked(lms, datatype, n_hosts, h, kw)
              for h in range(n_hosts)]
    # hosts are symmetric after the gather (replicated top), so one suffices
    return MH.run_multihost(lms, datatype, n_hosts=n_hosts, host_id=0,
                            gather=lambda _my: stacks, solver_kw=kw)


@pytest.mark.parametrize("datatype,n,n_hosts", [
    ("stereo", 8, 2),
    ("mono", 6, 2),   # mono (scale-gauge) decomposition in the DEFAULT tier
    pytest.param("mono", 8, 2, marks=pytest.mark.slow)])
def test_multihost_matches_single_process(datatype, n, n_hosts):
    # method="direct" (full f64): the decomposition is then exact to
    # padding-order rounding (~1e-13); the refine path's f32 low levels
    # amplify padding differences to ~1e-5 and are covered separately.
    kw = dict(method="direct")
    lms, _ = _dataset(n, datatype)
    ref = _poses_by_id(DeviceTreeSolver(datatype, **kw).run(lms))
    got = _poses_by_id(_run_simulated(lms, datatype, n_hosts, kw))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-10,
                                   err_msg=f"pose {k}")


@pytest.mark.parametrize("n,n_hosts", [
    (11, 2), pytest.param(13, 3, marks=pytest.mark.slow)])
def test_multihost_arbitrary_counts(n, n_hosts):
    """Carry-aware chunking: odd, non-power-of-two map counts (the reference
    NC3500 set is 3,499 maps) decompose exactly — partial tail blocks ride
    the global schedule as carries, incl. odd-position re-gauges."""
    kw = dict(method="direct")
    lms, _ = _dataset(n, "stereo")
    ref = _poses_by_id(DeviceTreeSolver("stereo", **kw).run(lms))
    got = _poses_by_id(_run_simulated(lms, "stereo", n_hosts, kw))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-10,
                                   err_msg=f"pose {k}")


@pytest.mark.slow
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_multihost_at_scale_odd_count(n_hosts):
    """Carry-aware decomposition at scale: 875 maps (= NC3500's 3,499 // 4;
    odd, non-power-of-two) on 2 and 4 simulated hosts, equality vs the
    single-process device tree. The full 3,499-map solve costs ~29 min per
    run on the forced-CPU test backend (measured), so solve-level equality
    is pinned at 875 and the 3,499 bookkeeping is asserted exactly in
    test_multihost_nc3500_plan below; the bench runs 3,499 end-to-end
    (BASELINE.md ladder)."""
    kw = dict(method="refine")
    lms, _ = _dataset(875, "stereo")
    ref = _poses_by_id(DeviceTreeSolver("stereo", **kw).run(lms))
    got = _poses_by_id(_run_simulated(lms, "stereo", n_hosts, kw))
    assert got.keys() == ref.keys()
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    assert err < 1e-6, err


@pytest.mark.parametrize("n_hosts", [2, 4, 5])
def test_multihost_nc3500_plan(n_hosts):
    """Exact decomposition bookkeeping at the reference's headline count
    (3,499 maps, /root/reference/README.txt:64): blocks tile the sequence,
    offsets align, every host's contribution is well-formed, and the
    replicated top phase sees the global level-L list in order."""
    L, block, owners = MH.plan_chunks(3499, n_hosts)
    assert owners[0][0] == 0 and owners[-1][1] == -(-3499 // block)
    for (a, b), (c, d) in zip(owners, owners[1:]):
        assert b == c and b >= a
    spans = MH._block_spans(3499, block, 0, owners[-1][1])
    assert spans[0][0] == 0 and spans[-1][1] == 3499
    for lo, hi in spans:
        assert lo % block == 0 and 0 < hi - lo <= block
        # planner alignment invariant: lo divisible through the block's own
        # reduction depth (plan_tree_exact asserts this at runtime)
        assert lo % (1 << MH._levels_of(hi - lo)) == 0


@pytest.mark.parametrize("datatype,port", [
    ("stereo", 12391),
    # mono (7-DOF scale gauge) through the REAL transport, slow tier
    pytest.param("mono", 12397, marks=pytest.mark.slow)])
def test_multihost_two_processes(tmp_path, datatype, port):
    """REAL multi-process run: 2 CPU processes, jax.distributed + allgather."""
    script = os.path.join(REPO, "tools", "multihost_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        # JAX_COMPILATION_CACHE_DIR comes from conftest: the machine-local
        # disk cache, so the workers don't recompile the whole subtree
        env.update(JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1")
        procs.append(subprocess.Popen(
            [sys.executable, script, f"127.0.0.1:{port}", "2", str(pid),
             str(tmp_path), datatype],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"worker {pid} failed:\n{outs[pid][-3000:]}"

    lms, _ = _dataset(8, datatype)
    ref = _poses_by_id(DeviceTreeSolver(datatype, method="direct").run(lms))
    for pid in range(2):
        f = np.load(tmp_path / f"result_{pid}.npz")
        got = {int(i): p for i, p in zip(f["ids"], f["poses"])}
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-10,
                                       err_msg=f"process {pid} pose {k}")
