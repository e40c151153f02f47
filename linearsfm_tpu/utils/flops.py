"""Host-side FLOP / memory-byte model of the device merge tree.

The reference's only performance instrumentation is one wall-clock printf
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:2068-2072); relative
maps/s against it cannot show how much of the device a solve uses. This
module prices every level program of a TreePlan from the exact capacity plan
(core/plan.py) so the bench can report achieved FLOP/s plus a memory-traffic
estimate. No device peak is kept here: a peaks table keyed by device kind
belongs with the benchmark.

Cost structure of one pair lane at a level with input caps (M, N, KU, KW):

* gauge transform (f64, elementwise — ops/congruence.py): congruence
  products ``J^T I J`` over the block lists + coupling/cross terms; ~2.5
  kFLOP per U block, ~1.2 kFLOP per W block, ~0.6 kFLOP per V block (counted
  from the congr/bmm einsum shapes in ops/smallmat.py).
* merged system (capacity concat, ops emission growth as in core/plan.py):
  stereo  M2=2M, N2=2N, KU2=2KU+M+1, KW2=2KW+N;
  mono    M2=2M, N2=2N, KU2=2KU+2M+3, KW2=2KW+2N.
* dense Schur assembly (f32 matmul — ops/schur._assemble_schur_dense):
  ``S = A - Yd Wd^T``: 2*(6*M2)^2*(3*N2); Y = W Vinv: 324*KW2.
* Cholesky factor of S (f32): (6*M2)^3 / 3.
* PCG sweeps (ops/schur.solve_full_mixed): per iteration one preconditioner
  application (two triangular solves, 2*2*(6*M2)^2, f32) and one
  full-system block matvec (f64 elementwise): 144*KU2 + 72*KW2 + 18*N2.
* re-gauge lanes pay a second transform at merged sizes.

Memory bytes per lane: one read+write of the lane pytree (f64) plus the
dense f32 stripes (Wd, Yd streamed once each, S read ~3x during factor and
solves).
"""

from __future__ import annotations


def merged_caps(caps, datatype):
    """(M2, N2, KU2, KW2) of one pair's joined system at level input caps."""
    M, N, KU, KW = caps
    if datatype == "stereo":
        return 2 * M, 2 * N, 2 * KU + M + 1, 2 * KW + N
    return 2 * M, 2 * N, 2 * KU + 2 * M + 3, 2 * KW + 2 * N


def _transform_f64(M, N, KU, KW):
    return 2500 * KU + 1200 * KW + 600 * N + 4000 * M


def level_cost(lp, datatype, iters: int) -> dict:
    """FLOP/byte model of one level program (all lanes)."""
    npair = lp.count // 2
    M, N, KU, KW = lp.caps_in
    M2, N2, KU2, KW2 = merged_caps(lp.caps_in, datatype)
    d = 6 * M2

    ew = _transform_f64(M, N, KU, KW)                   # pre-join transform
    nrg = sum(1 for f in (lp.regauge or ()) if f)
    mm = 2.0 * d * d * (3 * N2) + d ** 3 / 3.0          # assembly + factor
    mm += iters * 4.0 * d * d                           # preconditioner
    ew += iters * (144.0 * KU2 + 72.0 * KW2 + 18.0 * N2)    # PCG matvecs
    ew_total = npair * ew + nrg * _transform_f64(M2, N2, KU2, KW2)
    mm_total = npair * mm

    lane_bytes = 8 * 2 * (36 * KU2 + 18 * KW2 + 9 * N2 + 6 * M2 + 3 * N2)
    dense_bytes = 4 * (2 * d * 3 * N2 + 3 * d * d)
    mem = npair * (lane_bytes + dense_bytes)
    return dict(matmul_f32=mm_total, elementwise_f64=ew_total,
                mem_bytes=mem)


def tree_cost(tp, datatype, iters_fn) -> dict:
    """Whole-tree totals + per-level breakdown.

    iters_fn(join_m) -> PCG sweep count for that level (the solver's
    precision band, core/device_tree.DeviceTreeSolver._cfg).
    """
    levels = []
    tot = dict(matmul_f32=0.0, elementwise_f64=0.0, mem_bytes=0.0)
    for lp in tp.levels:
        it = iters_fn(lp.join_m if lp.join_m is not None
                      else 2 * lp.caps_in[0])
        c = level_cost(lp, datatype, it)
        levels.append(c)
        for k in tot:
            tot[k] += c[k]
    return dict(levels=levels, **tot)


def throughput(tp, datatype, iters_fn, wall_s: float) -> dict:
    """Modelled FLOPs and bytes of the tree, and the rates they imply over
    a measured wall."""
    c = tree_cost(tp, datatype, iters_fn)
    return dict(matmul_f32_flops=c["matmul_f32"],
                elementwise_f64_flops=c["elementwise_f64"],
                mem_gb=c["mem_bytes"] / 1e9,
                achieved_f32_tflops=c["matmul_f32"] / wall_s / 1e12,
                mem_gbps=c["mem_bytes"] / 1e9 / wall_s,
                levels=c["levels"])
