#!/usr/bin/env python3
"""On-card smoke test of ``ginkgo_tpu_torch``, the PyTorch/CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. card: name and power limit (``nvidia-smi``); exits 2 without CUDA;
2. build: compiles every hand-written kernel of ``ops/csrc`` with ``nvcc``
   (one process per source, all started together) and the port's native
   C++ host library with ``g++``;
3. kernel A (banded SpMV) against its plain PyTorch version on the card:
   small random banded matrices with k in {1, 3, 8, 9} in f32, f64 and
   bf16/f16 storage, and the 27-point stencil at nx=160 with k=1, timed
   beside its byte bound, its plain version and cuSPARSE;
4. kernel B (packed windowed-ELL SpMV: ``sell_spmv.cu`` over the packed
   slab's compact stream), the same on small matrices in every type pair
   and, against the stream's plain version and the slab's, on the locally
   permuted 1,048,576-row stencil and on the ILU system's FEM matrix, with
   the stream's slots, pad ratio and repack milliseconds beside the slab's;
5. kernel C (packed exact triangular solve: a cluster of 8 CTAs walking
   the chain of 256-row blocks), the same on small random lower and upper
   factors (f32 and f64 right-hand sides) and on the L factor of the ILU
   system below, timed beside its byte bound, its plain version and
   cuSPARSE's triangular solve, with the plan's P, Wv, nb, its chain depth
   (counted from the cross slots), ms a block and the cluster and ring the
   launch uses; four of its block inverses are checked against an f64
   inverse, and four more built with TF32 turned on by the caller;
6. main path, banded: ``Csr.from_data`` of the nx=160 stencil on the card
   (``banded`` layout), Jacobi-CG to the tolerance below, with kernel A's
   launch count and the true residual recomputed independently;
7. main path, packed: the same on the permuted matrix (``packed`` layout),
   in the iterations the slab kernel took (``SLAB_ITERATIONS``, as the
   ILU and ILUT paths below);
8. main path, ILU: the 262,144-row unstructured FEM matrix of the
   benchmark cases (``packed`` layout), ``Ilu(ParIlu(5))`` with both
   triangular solves on kernel C, BiCGSTAB to ``ResidualNorm(1e-5)`` with
   kernels B and C counted, the true residual recomputed, and fewer
   iterations than BiCGSTAB without a preconditioner;
9. ParILUT generate: ``ParIlut(iterations=5)`` (``auto``, f32) on the ILU
   system's matrix takes the packed device loop, with exactly 42 launches
   of kernel D (23 on the product plan, 19 on the denominator plan), the
   stagetimer's host/transfer/device split, and both triangular solves of
   ``Ilu(ParIlut)`` on kernel C;
   then a second generate of the same matrix on the cached plan (the
   time-dependent-coefficients workflow: no planning, the pair streams
   kept on the card), counted as a main path of its own, with its split
   and factors equal to the first's;
10. main path, ILUT: Ilu(ParIlut)-BiCGSTAB to ``ResidualNorm(1e-5)`` as in
   8, in fewer iterations than without a preconditioner;
11. the same generate with the one-hot scatter (``_DOT_MODE = "onehot"``):
   42 launches of kernel E and factors that agree with 9's;
12. kernels D and E (pair contraction over the plan's pad-free pair
   stream) at the product and denominator plans of that generate, against
   their plain version on the plan's slabs and an f64 raw-triple oracle,
   kernel D twice bit for bit, timed beside their byte bound, their plain
   version and the gather + ``index_add_`` of the raw triples, with each
   plan's live-vreg fill, stream bytes, repack ms and the card bytes the
   stream frees against the slabs;
13. small solves on the card agree with the port's CPU run: Jacobi-CG and
   Ic-CG in f64, Ilu-BiCGSTAB in f32 and f64, packed ParILUT and ParICT
   factors in f64, and Ilu(ParIlut)-BiCGSTAB in f32;
14. kernel F (in-place Krylov-basis row write): random rows into f32, f64,
   bf16, f16, int16, int8, complex64 and complex128 stores of the
   (m_pad, n) and (m_pad, n, 3) layouts, bit for bit the plain ``copy_``,
   in place and allocating nothing; timed at n = 4,096,000 f32 beside its
   byte bound, its plain version and ``store[i].copy_(row)``, the kernel
   (a ring of TMA bulk copies) and ``copy_`` in five rounds of turns;
15. main path, GMRES: ``Gmres.solve`` on the nx=160 stencil (f32,
   krylov_dim 100, CGS2, ``ResidualNorm(1e-3)``), then ``CbGmres`` with a
   bf16 (``reduce1``) and an int16 (``integer``) basis, each converged to
   a true residual under 1e-3, with kernel A counted and kernel F's
   launches equal to the Arnoldi steps plus the ``restart_fields`` calls;
16. GMRES with TF32 turned on by the caller: the same iterations and x;
17. kernels G and H (the attic windowed-ELL and chunk-ELL SpMVs, both
   ``sell_spmv.cu`` over their slab's compact stream): planned on the ILU
   system's matrix, applied with their COO tails through the attic's own
   apply (the counted path), held against the stream's and the slab's
   plain versions, an f64 product and small random matrices with k in
   {1, 3, 8, 9}, and timed beside their byte bounds, their plain versions
   and cuSPARSE, with each stream's entries, pad ratio, repack ms and the
   card bytes it frees against the slab;
18. small GMRES solves on the card agree with the port's CPU run: f64,
   ``keep`` and ``integer`` bases, two right-hand sides;
18a. main path, block Jacobi: ``Cg`` with ``Jacobi(max_block_size=8)`` on
   the nx=160 stencil to ``ResidualNorm(2e-4)``, its iterations beside
   scalar Jacobi-CG's (phase 6), the generate's seconds, the apply's ms
   and kernel A's launches, the true residual recomputed;
18b. main path, DIA ParILUT: ``Ilu(ParIlut(iterations=5))`` (``auto``,
   f32) on ``stencil_3d(64, points=27)`` (n = 262,144) takes the DIA
   loop (``route == "dia"``), with the stagetimer's host/transfer/device
   split and the trisolve algorithms the factors get; BiCGSTAB to
   ``ResidualNorm(5e-5)`` (``DIA_TOL``: f32 stalls near 1.7e-5 here) in
   fewer iterations than without it, the true residual under 5e-5, and
   the same solves to 1e-5 with and without it to show that floor; then
   ``Ic(ParIct(iterations=5))``-CG the same way, and the adaptive block
   Jacobi (``storage_optimization="auto"``) CG on the same matrix;
18c. small f64 runs on the card agree with the port's CPU run: DIA
   ParILUT and ParICT factors at nx = 8, block-Jacobi CG (block size 4,
   adaptive, natural blocks);
18d. main path, the format zoo on kernel A: ``Ell`` and ``Hybrid``
   (``automatic``, 0.8) of the nx=160 stencil and ``Coo``, ``Sellp`` and
   ``Fbcsr(4)`` of the nx=100 one (f32; ``CUT_FORMATS``) must plan
   ``banded``;
   each applies at k = 1 and 3 against the plain COO product in f64 on
   the card, one kernel-A launch an apply, timed beside the ``Csr``'s
   apply, with its ``from_data`` seconds and card bytes; Jacobi-CG with
   the ``Ell`` operator takes phase 6's iterations and x bit for bit;
   ``SparsityCsr`` of the nx=100 pattern applied to ones is value x its
   row sums; then ``diagonal``: the five ``Diagonal`` methods the port
   gained (``rapply``, ``compute_absolute``, ``conj_transpose``,
   ``transpose``, ``from_data``) on the nx=160 system's
   ``Coo.extract_diagonal`` against their plain torch formulas;
18e. Matrix Market and binary I/O: the ILU system's FEM matrix written
   with ``write_mtx`` and read back on the native path and through
   ``build_matrix_data({"filename": ...})``, and through ``write_binary``/
   ``read_binary`` in f64/int64 and f32/int32, each equal to the
   generated entries, with the seconds of each;
18f. main path, the format zoo on kernel B: ``Coo``, ``Ell``, ``Sellp``,
   ``Hybrid`` (``minimal_storage_limit``) and ``Fbcsr(4)`` of the data
   read back must plan ``packed``, held and timed as in 18d; BiCGSTAB without a
   preconditioner on the ``Hybrid`` takes the bare ``Csr`` solve's
   iterations (phase 8); ``Csr.permute`` by a seeded permutation agrees
   with ``Permutation`` on both sides; ``RowGatherer`` and ``CsrLookup``
   (a million seeded queries) agree with host numpy; ``Fft3(160)`` on a
   seeded complex64 grid agrees with ``numpy.fft.fftn`` in f64;
18g. every format on small f64 and complex128 matrices, banded and
   packed (the complex ones on the complex instantiations of A and B),
   on the card against the port's CPU run: applies to 1e-12,
   ``to_matrix_data`` and the conversions exactly;
18h. main path, ISAI and SOR on the ILU system (f32, BiCGSTAB to
   ``ResidualNorm(1e-5)``, beside the bare solve's and ILU's iterations):
   ``Isai()`` takes the packed fill and M plans ``packed`` (kernel B; a
   second generate on the cached symbolics timed too); ``GaussSeidel()``
   and ``Sor(1.2, symmetric=True)`` with the trisolve algorithm ``auto``
   chose for each factor and why when it is not ``exact_packed`` (kernel
   C); each with its stagetimer split, ms per iteration, launches and
   the true residual; then ``rcm_case``: the ILU case with ``rcm``, the
   layout the planner chose and one SpMV beside the unreordered one's;
18i. main path, ISAI(spd) on the DIA system (after 18b):
   ``Isai(mode="spd")``-CG to ``DIA_TOL``: IC(0), the DIA block fill,
   both inverse factors ``banded`` (three kernel-A launches an
   iteration), its apply timed, scalar-Jacobi CG's iterations beside;
18j. the direct solvers: nested-dissection ``ScaledReordered`` around
   ``Direct(Lu())`` and ``Direct(Cholesky())`` on ``stencil_2d(256)``
   (n = 65,536, f64, b = ones): ordering and host factorization seconds,
   L and U entries, the trisolve algorithm and levels, ms per solve, the
   true residual under ``DIRECT_TOL``;
18k. ``Csr.spgemm`` of the nx=64 7- and 27-point stencils with
   themselves: the device numeric and the host streaming merge, each
   against the native host product (same pattern, values to
   ``SPGEMM_TOL``);
18l. small f64 runs on the card agree with the port's CPU run: ISAI in
   four modes, SSOR, Gauss-Seidel, ``Direct``, MC64-``ScaledReordered``
   and the device SpGEMM numeric, on a stencil and a FEM matrix;
18m. main path, multigrid on the DIA system (after 18i):
   ``Multigrid.build().generate`` of the nx=64 f32 stencil (``Pgm``'s
   ``auto`` must take the ``dia`` matcher on the fine level), each
   level's rows, entries, layout, route and transfer layout, the
   generate's stagetimer split, one V-cycle's launches and its host
   time beside the card's busy time (``torch.profiler``); MG-CG to
   ``DIA_TOL`` in fewer iterations than scalar-Jacobi CG, the true
   residual under it, the launches of kernels A and B an iteration; the
   standalone ``Multigrid`` solve and W-cycle CG to the same tolerance;
   then ``ir_df64`` (4 sweeps, inner CG to ``[Iteration(200),
   ResidualNorm(1e-6)]``): the df64 iterate's f64 true residual under
   5e-11; the mixed multigrid (the same stencil in f64 on kernel A's f64
   instance, ``coarse_dtype=torch.float32``): CG to 1e-8 with the f64
   true residual under it; ``ir_dc64`` on A = P (1 + 0.02i) + 0.5i I of
   that stencil (complex64 BiCGSTAB to 1e-5 on kernel A-c inside, 5
   sweeps): the complex128 true residual under 1e-11;
18n. small f64 runs on the card agree with the port's CPU run: the
   ``dia`` and ``packed`` matchers' roots index for index (``stencil_3d(8,
   points=27)``, the FEM matrix at n = 2,048), MG-CG with the V, W, F and
   K cycles (equal iterations, x to 1e-10);
18o. main path, multigrid on the ILU system (after 18h): ``auto`` takes
   the ``packed`` matcher (``plan_offsets`` declines the FEM matrix),
   aggregates of at most 8 rows; V-cycle-preconditioned BiCGSTAB to
   ``ResidualNorm(1e-5)`` in fewer iterations than the bare solve's,
   beside ILU's;
18p. main path, autodiff (after 18a): ``make_differentiable_solve`` of
   Jacobi-CG on the nx=160 system (f32, ``SOLVE_TOL``), loss ||x||^2,
   forward and adjoint solves counted (kernel A), gradients to b and to
   the banded diagonals; grad_b against an independent solve of the
   adjoint system and its f64 residual; ``Csr.conj_transpose`` timed;
   then the f64 central-difference check along a seeded symmetric
   direction of the diagonals of ``stencil_3d(FD_NX, points=27)``;
18q. ``config_solve``: ``parse_json`` of a Jacobi-CG config generated on
   the same system takes the main path's iterations under a
   ``Convergence`` logger, with a ``ProfilerHook`` summary; a second
   solve inside ``trace_to`` writes a Chrome trace that names kernel A
   as often as its wrapper counted;
18r. ``utils_card``: ``checkpoint.save``/``load`` of the banded ``Csr``
   (applied bit for bit equal), ``serialize_solve``/``load_solve`` of
   the Jacobi-CG (x bit for bit the direct solve's), ``DeviceTimer``
   and ``topology()``;
18s. the batch tier (after 18l): ``BatchCg`` (f32, 1e-6) on 65,536
   tridiagonal systems of 32 rows and 8,192 of 128 (``BATCH_CG_SHAPES``),
   then block-Jacobi ``BatchBicgstab`` (f32, 1e-5) on 65,536 scaled
   24-row SPD systems and, at 8,192, through ``BatchEll`` and
   ``BatchDense`` with x against the ``BatchCsr``'s: ms a solve,
   systems/s, iterations, every system's f64 true residual under
   ``BATCH_TRUE_LIMIT``, one solve under ``torch.profiler``; then
   ``batch_match``: a small f64 batch on the card and on the host, equal
   iterations a lane and x to 1e-12;
19. the complex path at full width: ``Csr.from_data(..., dtype=
   np.complex64)`` of A = P (1 + 0.02i) + 0.5i I (P the nx=160 stencil,
   ``banded`` layout), of the Hermitian H = P + 1.02 I + 0.02i (U - U^T)
   (U the strict upper triangle of P, ``banded``) and of A on the
   permuted matrix (``packed``);
20. kernels A and B in their complex instantiations (``kernel_a_complex``,
   ``kernel_b_complex``): small random matrices in every type pair they
   take with k in {1, 3, 8, 9}, then the complex main-path matrices at
   k = 1, timed beside their byte bound, their plain versions and
   cuSPARSE;
21. main path, complex: Bicgstab, Bicg, Cgs, Gcr(100), Gmres(100, CGS2),
   Idr(2) and Ir with a Gmres(15 iterations) inner solver on A, and Cg,
   Fcg, PipeCg, Minres and Chebyshev on H (``main_complex_banded``,
   ``main_complex_hermitian``), Jacobi-BiCGSTAB on the packed A
   (``main_complex_packed``), each to ``ResidualNorm(1e-5)`` with its
   iterations, ms per iteration, launches and the true residual
   recomputed in complex128 under 1e-4 (BiCG and PipeCg to their
   ``STALL_TOLS`` and under them: see the constant);
22. the main path's own entry points: ``bench_torch``'s STREAM and SpMV
   measurements (its JSON line printed) and ``graft_entry_torch.entry()``
   against the same entry on the host;
23. all twelve Krylov solvers on small complex128 systems, banded and
   packed, on the card against the port's CPU run: equal iterations, x to
   1e-10.

The line before the last is a JSON object with every kernel's launches on
the main paths, error against its plain version, time, plain time, bound
and library time (cuSPARSE for A-C, G, H and the complex A and B; for D
and E, whose contraction no single PyTorch call computes, the gather +
``index_add_`` of the raw pair triples, on the product plan; for F
``copy_``, the median of rounds timed in turns with the kernel); the last
line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
import graft_entry_torch
import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.base.linop import tensor_leaves
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import (Cholesky, Lu, ParIct, ParIlu,
                                            ParIlut, par_ilut_packed)
from ginkgo_tpu_torch.ops import (_cuda, pair_contract, registry,
                                  row_write, spgemm, spmv_banded,
                                  spmv_packed, spmv_sell, tri_packed)
from ginkgo_tpu_torch.ops.attic import spmv_chunked, spmv_windowed
from ginkgo_tpu_torch.matrix.csr_lookup import CsrLookup
from ginkgo_tpu_torch.multigrid import pgm_dia, pgm_packed
from ginkgo_tpu_torch.ops.dc64 import dc_from_c64, dc_to_c128, ir_dc64
from ginkgo_tpu_torch.ops.df64 import ir_df64
from ginkgo_tpu_torch.matrix.permutation import permute_data
from ginkgo_tpu_torch.ops.spmv import coo_spmv
from ginkgo_tpu_torch.preconditioner import (GaussSeidel, Ic, Ilu, Isai,
                                             Jacobi, Sor)
from ginkgo_tpu_torch.preconditioner import isai as isai_mod
from ginkgo_tpu_torch.reorder import Mc64, NestedDissection, ScaledReordered
from ginkgo_tpu_torch.solver import (Bicg, Bicgstab, CbGmres, Cg, Cgs,
                                     Chebyshev, Direct, Fcg, Gcr, Gmres,
                                     Idr, Ir, Minres, Multigrid, PipeCg)
from ginkgo_tpu_torch.solver.multigrid import MultigridOp
from ginkgo_tpu_torch.solver import gmres as gmres_mod
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.ops.tri_inv import batched_lowtri_inverse
from ginkgo_tpu_torch.utils import stagetimer
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               make_spd, permute_locally,
                                               random_banded,
                                               random_lower_factor,
                                               stencil_2d, stencil_3d,
                                               symmetric_part)
from ginkgo_tpu_torch import batch as tbatch
from ginkgo_tpu_torch.autodiff import make_differentiable_solve
from ginkgo_tpu_torch.config import parse_json
from ginkgo_tpu_torch.log import (Convergence, ProfilerHook, capture,
                                  trace_to)
from ginkgo_tpu_torch.solver import cg as cg_mod
from ginkgo_tpu_torch.utils import DeviceTimer, checkpoint, topology
from ginkgo_tpu_torch.utils.export import load_solve, serialize_solve

# H100 SXM data sheet: memory rate
# and the non-tensor-core f32 rate the kernels' multiply-adds run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

BANDED_NX = 160                      # the size bench.py measures on a chip
PACKED_DIMS = (256, 64, 64)          # 1,048,576 rows once permuted
# ResidualNorm, relative to ||b||.  f32 CG on the nx=160 stencil stalls
# at a true residual of about 1.1e-4 (tools/torch_solve_probe.py), so a
# tighter tolerance ends in the audit's "stagnated"; the f64 recheck holds
# the solve to the tolerance it claims
SOLVE_TOL = 2e-4
TRUE_RESIDUAL_LIMIT = SOLVE_TOL
# the ILU path: the repo's unstructured preconditioner case, f32
ILU_CASE = {"fem": 262144, "offscale": 1.2}
ILU_TOL = 1e-5
# the ParILUT path: the JAX package's benchmark preset "parilut"
# (Ilu(factorization=ParIlut(iterations=5))); one generate with two sweeps
# an iteration contracts 23 times on the product plan and 19 times on the
# denominator plan (par_ilut_packed._run_packed)
ILUT_ITERATIONS = 5
ILUT_LAUNCHES = {"prod": 23, "den": 19}
# pair contraction against its plain version and the f64 oracle, relative
# to max |y|: f32 sums in another order, and kernel D's cumsum difference
# loses digits to cancellation (the JAX package's tolerances)
PAIR_TOL = {"pair_contract_cumsum": 1e-5, "pair_contract_onehot": 2e-5}
# kernel E's ParILUT factors against kernel D's on their shared slots,
# relative to max |value|: the threshold select reacts to f32 sums in
# another order (3.7e-3 on L and 4.5e-3 on U in three runs on the H100),
# far below the O(1) of values gone wrong
ONEHOT_FACTOR_TOL = 2e-2
# the GMRES path: the JAX package's solver benchmark on the nx=160 stencil
# (benchmark_results/tpu_v5e/solver_large.json, "stencil(27pt, 160)"):
# the solver defaults krylov_dim=100 and CGS2, rel_res_goal 1e-3; the
# bases of CB-GMRES: bf16 (reduce1 of f32) and int16 (integer)
GMRES_KRYLOV_DIM = 100
GMRES_TOL = 1e-3
CB_STORAGES = ("reduce1", "integer")
# kernels G and H against their plain versions and an f64 product,
# relative to max |y|: f32 sums in another order
ATTIC_TOL = 1e-5
# the DIA ParILUT/ParICT path: the 27-point stencil at nx = 64, n =
# 262,144, the size the JAX package measured its DIA path at
# (BENCHMARKS.md, "27-pt n = 262k"), f32.  Preconditioned f32 BiCGSTAB
# and CG there stall at a true residual of 1.5-1.7e-5 (on the H100), so
# a 1e-5 goal ends in the audit's "stagnated"; each solve goes to 5e-5
# and the f64 recheck holds it to that
DIA_NX = 64
DIA_ITERATIONS = 5
DIA_TOL = 5e-5
# block Jacobi: Ginkgo's default block size, on the banded main-path
# system to the f32 CG stall tolerance above; the adaptive storage once at
# the DIA path's size
BLOCK_SIZE = 8
# iterations of the solves that run kernel B, as the kernel over the
# padded slab took them on the card: the compact stream sums each row in
# the slab's order and only drops its zero lanes, so they must not move
SLAB_ITERATIONS = {"packed": 125, "ilu": 5, "ilut": 4}
# the complex path: the JAX package's chip-verified complex model problem
# A = P (1 + 0.02i) + 0.5i I (tools/measure_round4.py:95-156) and the
# Hermitian H = P + 1.02 I + 0.02i (U - U^T), U the strict upper triangle
# of P, both in complex64 at nx = 160; each solve to ResidualNorm(1e-5),
# its true residual recomputed in complex128 held under 1e-4
COMPLEX_TOL = 1e-5
COMPLEX_TRUE_LIMIT = 1e-4
COMPLEX_KRYLOV_DIM = 100
# Two solvers cannot meet 1e-5 in complex64 on these systems, in the JAX
# package as in the port (tools/torch_complex_probe.py; PERF.md), so each
# is solved, and its true residual held, to its own tolerance:
# - BiCG's complex recurrence (the JAX package's, mirrored: the shadow
#   direction takes beta unconjugated) stalls: its recurrent residual
#   bottoms out near 3e-2 at nx=160;
# - pipelined CG's recurrences drift from the true residual in f32: the
#   recurrent residual goes on falling while the true one stops near 1e-4
#   and then grows
STALL_TOLS = {"Bicg": 5e-2, "PipeCg": 1e-3}
# an enclosure of H's spectrum (a loose one at the top): P's lies in
# (0, 36), the Hermitian term's spectral radius is at most 0.02 * 26
CHEBYSHEV_FOCI = (0.5, 53.6)
# (values, vector) pairs of the complex instantiations of kernels A and B
COMPLEX_PAIRS = ((torch.complex64, torch.complex64),
                 (torch.float32, torch.complex64),
                 (torch.bfloat16, torch.complex64),
                 (torch.float16, torch.complex64),
                 (torch.complex64, torch.float32),
                 (torch.complex128, torch.complex128))
# the format zoo (kernels A and B through each format's SpmvPlan), on the
# nx=160 stencil and on the ILU system's FEM matrix read back from its
# Matrix Market file
FORMAT_BUILDS = {
    "Coo": lambda d, **kw: gtt.Coo.from_data(d, **kw),
    "Ell": lambda d, **kw: gtt.Ell.from_data(d, **kw),
    "Sellp": lambda d, **kw: gtt.Sellp.from_data(d, **kw),
    "Hybrid": lambda d, strategy="automatic", **kw: gtt.Hybrid.from_data(
        d, strategy=strategy, percent=0.8, **kw),
    "Fbcsr": lambda d, **kw: gtt.Fbcsr.from_data(d, block_size=4, **kw),
}
# the formats whose set-up the script cuts by building them at nx=100
# (1,000,000 rows) instead of the banded system's 160; each still plans
# ``banded`` and launches kernel A
SMALL_FORMAT_NX = 100
CUT_FORMATS = ("Coo", "Sellp", "Fbcsr", "SparsityCsr")
# the packed solve's Hybrid (BiCGSTAB without a preconditioner)
HYBRID_SOLVE_STRATEGY = "minimal_storage_limit"
# the direct solvers: ND-ordered LU and Cholesky of the 2-D 5-point
# stencil at n = 65,536, f64, b = ones, each solve's true residual under
# DIRECT_TOL; DIRECT_SOLVES timed solves after the first
DIRECT_NX = 256
DIRECT_TOL = 1e-10
DIRECT_SOLVES = 3
# Csr.spgemm of the nx=64 7- and 27-point stencils with themselves (f32):
# 12.5M contribution pairs take the device numeric, 181M the host merge;
# each against the native host product, relative to max |value|
SPGEMM_NX = 64
SPGEMM_TOL = 1e-6
LOOKUP_QUERIES = 1_000_000
FFT_EDGE = BANDED_NX
# the mixed multigrid's tolerance (f64 fine level), and the refinements'
# sweeps and pins (tests/test_df64.py, tests/test_complex_sweep.py)
MIXED_TOL = 1e-8
IR_DF64_SWEEPS = 4
IR_DF64_LIMIT = 5e-11
IR_DC64_SWEEPS = 5
IR_DC64_LIMIT = 1e-11
# the batch tier: BatchCg (f32, tolerance 1e-6) on tridiagonal SPD systems
# -1, 2 + s, -1 with s uniform in [0.1, 1.0], at the JAX package's own batch
# case shapes (BENCHMARKS.md, "Batch solver"), right-hand sides drawn from
# a seeded normal as the repo's batched-solver example draws them; then
# block-Jacobi BatchBicgstab (f32, 1e-5) on tools/tpu_smoke.py's 24-row
# SPD pattern with seeded scales, its BatchEll and BatchDense at 8,192
# systems; the f64 true residual of every system held under
# BATCH_TRUE_LIMIT, and BatchEll's/BatchDense's x against BatchCsr's,
# relative to max |x|, under BATCH_FORMAT_TOL
BATCH_CG_SHAPES = ((65536, 32), (8192, 128))
BATCH_CG_TOL = 1e-6
BATCH_BICGSTAB_SYSTEMS = 65536
BATCH_FORMAT_SYSTEMS = 8192
BATCH_BICGSTAB_TOL = 1e-5
BATCH_TRUE_LIMIT = 1e-5
BATCH_FORMAT_TOL = 1e-4
BATCH_REPS = 5
# the differentiable CG's central-difference check: f64 on the nx=32
# 27-point stencil, plain CG to 1e-12, step FD_STEP along a seeded
# positive symmetric direction of the diagonals, held to FD_TOL relative
# (on the CPU the error is 6e-9 at this step and falls as its square)
FD_NX = 32
FD_STEP = 5e-7
FD_TOL = 1e-6
DEV = torch.device("cuda")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5,
       torch.float16: 1e-5, torch.complex64: 1e-5, torch.complex128: 1e-12}


# the host clock when the script started: every phase line carries its
# wall seconds since then (``wall_s``), so a phase's cost is the
# difference to the line before it
START = time.perf_counter()


def say(phase, **fields):
    print(json.dumps({"phase": phase,
                      "wall_s": time.perf_counter() - START, **fields}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# about 20 ms of a spinning kernel at the H100's clock: the host enqueues
# the timed launches behind it
QUEUE_AHEAD_CYCLES = 40_000_000


def time_ms(fn, reps, queue_ahead=False):
    """Mean ms per call from CUDA events around ``reps`` calls, after one
    warm-up call.  With ``queue_ahead`` the card first spins while the
    host enqueues the calls, so launches that take less time on the card
    than on the host run back to back and the events time the card, not
    the host (a launch through a wrapper costs tens of µs of Python)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if queue_ahead and start.query():
        raise AssertionError("the card finished spinning before the host "
                             "had enqueued the timed launches")
    end.synchronize()
    return start.elapsed_time(end) / reps


def stream_gbps():
    """Device copy rate: 1 GiB read + 1 GiB written per copy."""
    src = torch.empty(1 << 28, dtype=torch.float32, device=DEV)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 20)
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


def rel_err(got, want):
    """max |got - want| / max |want|, in f64 (complex128 for complex)."""
    wide = (torch.complex128 if got.is_complex() or want.is_complex()
            else torch.float64)
    got, want = got.to(wide), want.to(wide)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-300), scale


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(A, x, reps):
    """cuSPARSE's CSR SpMM on the same matrix: the yardstick the port
    itself never calls."""
    nnz = A.nnz
    S = torch.sparse_csr_tensor(A.row_ptr, A.col_idx[:nnz], A.values[:nnz],
                                size=A.shape)
    y = S @ x
    return time_ms(lambda: S @ x, reps, queue_ahead=True), y


# -- kernel A -----------------------------------------------------------------
def banded_case(n, offsets, vdtype, seed):
    g = np.random.default_rng(seed)
    dv = g.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off < 0:
            dv[d, :-off] = 0
        elif off > 0:
            dv[d, n - off:] = 0
    meta = spmv_banded.plan_banded_layout(tuple(offsets), n)
    dvb = torch.from_numpy(spmv_banded.block_diag_values(dv, meta))
    return meta, dvb.to(device=DEV, dtype=vdtype)


def check_dia(offsets, dvb, meta, x):
    y = spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x)
    torch.cuda.synchronize()
    want = spmv_banded.dia_spmv_reference(offsets, dvb, meta, x)
    assert y.shape == want.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    err, _ = rel_err(y, want)
    tol = TOL[dvb.dtype]
    if not err <= tol:
        raise AssertionError(f"dia_spmv kernel disagrees: rel err {err:.3e}"
                             f" > {tol} (dvb {dvb.dtype}, x {x.dtype}, "
                             f"shape {tuple(x.shape)})")
    return err


def phase_kernel_a(A):
    worst = {}
    for n, offsets in ((1000, (-1, 0, 1)),
                       (5000, (-130, -129, -128, -1, 0, 1, 128, 129, 130)),
                       (3000, (-257, 0, 257)), (700, (0,))):
        for vdtype in (torch.float32, torch.float64, torch.bfloat16,
                       torch.float16):
            xdtype = torch.float64 if vdtype == torch.float64 \
                else torch.float32
            meta, dvb = banded_case(n, offsets, vdtype, seed=n)
            for k in (1, 3, 8, 9):
                x = torch.randn((n, k), dtype=xdtype, device=DEV)
                err = check_dia(offsets, dvb, meta, x)
                worst[str(vdtype)] = max(worst.get(str(vdtype), 0.0), err)
    say("kernel_a_small", max_rel_err=worst)

    n = A.shape[0]
    offsets, meta = A.diag_offsets, dict(A.band_meta)
    x = torch.randn((n, 1), dtype=torch.float32, device=DEV)
    y = spmv_banded.dia_spmv_cuda(offsets, A.diag_values, meta, x)
    want = spmv_banded.dia_spmv_reference(offsets, A.diag_values, meta, x)
    err, scale = rel_err(y, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"dia_spmv kernel disagrees at nx={BANDED_NX}:"
                             f" rel err {err:.3e}")
    ms = time_ms(lambda: spmv_banded.dia_spmv_cuda(
        offsets, A.diag_values, meta, x), 50, queue_ahead=True)
    plain = time_ms(lambda: spmv_banded.dia_spmv_reference(
        offsets, A.diag_values, meta, x), 10)
    lib, ylib = library_ms(A, x, 20)
    lib_err, _ = rel_err(ylib, want)
    D = len(offsets)
    # the entries the function needs: the band's nonzero values (its
    # offsets are static), x read once and y written once
    entries = int((A.diag_values != 0).sum())
    nbytes = entries * A.diag_values.element_size() + 2 * n * 4
    bms, by = bound(nbytes, 2 * entries)
    say("kernel_a", n=n, D=D, k=1, entries=entries, band_slots=D * n, ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
        bytes=nbytes,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err, library_rel_err=lib_err)
    return dict(name="dia_spmv", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/dia_spmv.cu",
                replaces="ginkgo_tpu/ops/spmv_pallas.py:98",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


# -- kernel B -----------------------------------------------------------------
def card_slab(A):
    """A copy on the card of the packed slab that ``A`` keeps on the host
    (the oracle's input)."""
    return [t.to(DEV) for t in (A.pell_vals, A.pell_idx, A.pell_qw,
                                A.pell_xbase)]


def packed_stream(A, vdtype):
    """The packed slab of ``A`` on the card with its values in ``vdtype``,
    and that slab's compact stream."""
    slab = card_slab(A)
    slab[0] = slab[0].to(vdtype)
    return slab, spmv_sell.sell_from_packed(*slab, A.pell_meta)


def check_stream_kernel(wrapper, sell, smeta, slab_plain, x):
    """One call of a wrapper of ``sell_spmv.cu`` against the stream's plain
    version and the slab's (``slab_plain(x)``); returns the larger
    relative error."""
    y = wrapper(sell, smeta, x)
    torch.cuda.synchronize()
    want = spmv_sell.sell_spmv_reference(sell, smeta, x)
    assert y.shape == want.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    err = max(rel_err(y, want)[0], rel_err(y, slab_plain(x))[0])
    tol = TOL[sell["sv"].dtype]
    if not err <= tol:
        raise AssertionError(f"{wrapper.__name__} disagrees: rel err "
                             f"{err:.3e} > {tol} (values "
                             f"{sell['sv'].dtype}, x {x.dtype}, shape "
                             f"{tuple(x.shape)})")
    return err


def repack(build, slab, meta, built):
    """Milliseconds of one more build of the compact stream on the card,
    which must give the stream built at set-up bit for bit."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sell, smeta = build(*slab, meta)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if smeta != built[1] or not all(torch.equal(sell[key], built[0][key])
                                    for key in spmv_sell.STREAM):
        raise AssertionError("a second build of the compact stream differs")
    return ms


def stream_fields(sell, smeta, slab):
    """Entries, slots and bytes of a compact stream beside its slab's."""
    entries = dict(smeta)["entries"]
    slots = sell["sv"].numel()
    slab_slots = slab[0].numel()
    stream_bytes = sum(sell[key].numel() * sell[key].element_size()
                       for key in ("sv", "sc", "sp"))
    slab_bytes = sum(t.numel() * t.element_size() for t in slab[:3])
    return dict(entries=entries, stream_slots=slots,
                stream_pad_ratio=slots / entries, slab_slots=slab_slots,
                slab_pad_ratio=slab_slots / entries,
                stream_device_bytes=stream_bytes, slab_bytes=slab_bytes,
                bytes_per_launch_ratio=slab_bytes / stream_bytes)


def stream_needed_bytes(entries, value_size, n, m):
    """Bytes the ELL part needs at least: each kept entry's value and int16
    column (the slab's and the slices' padding are the layout's, not the
    function's), x read once and y written once (f32)."""
    return entries * (value_size + 2) + (m + n) * 4


def time_packed(label, A):
    """Kernel B at k = 1 on ``A``'s stream: checked against both plain
    versions, timed beside its bound, the plain version and cuSPARSE."""
    n, m = A.shape
    if A.pell_vals.device.type != "cpu":
        raise AssertionError("the packed slab should stay on the host")
    slab = card_slab(A)
    repack_ms = repack(spmv_sell.sell_from_packed, slab, A.pell_meta,
                       (A.sell, A.sell_meta))
    sell, smeta = A.sell, A.sell_meta
    x = torch.randn((m, 1), dtype=torch.float32, device=DEV)
    y = spmv_packed.pell_spmv_cuda(sell, smeta, x)
    want = spmv_sell.sell_spmv_reference(sell, smeta, x)
    err, scale = rel_err(y, want)
    slab_err, _ = rel_err(y, spmv_packed.pell_spmv_reference(
        *slab, A.pell_meta, x))
    if not max(err, slab_err) <= TOL[torch.float32]:
        raise AssertionError(f"pell_spmv kernel disagrees on the {label} "
                             f"matrix: rel err {err:.3e} to the stream's "
                             f"plain version, {slab_err:.3e} to the slab's")
    ms = time_ms(lambda: spmv_packed.pell_spmv_cuda(sell, smeta, x), 50,
                 queue_ahead=True)
    plain = time_ms(lambda: spmv_sell.sell_spmv_reference(sell, smeta, x), 5)
    lib, ylib = library_ms(A, x, 20)
    lib_err, _ = rel_err(ylib, want)
    fields = stream_fields(sell, smeta, slab)
    nbytes = stream_needed_bytes(fields["entries"],
                                 A.pell_vals.element_size(), n, m)
    bms, by = bound(nbytes, 2 * fields["entries"])
    meta = dict(A.pell_meta)
    say("kernel_b", matrix=label, n=n, Wv=meta["Wv"], XW=meta["XW"], k=1,
        nnz=A.nnz, **fields, repack_ms=repack_ms, ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=bms, bound_by=by, bytes=nbytes,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err, slab_rel_err=slab_err,
        library_rel_err=lib_err)
    return dict(name="pell_spmv", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/sell_spmv.cu",
                replaces="ginkgo_tpu/ops/spmv_packed.py:235",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


def small_packed_matrices():
    g = np.random.default_rng(11)
    n, n_off = 3000, 24               # the FEM-like pattern of the tests
    offs = g.integers(-500, 500, (-(-n // 128), n_off))
    pick = g.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    yield gtt.MatrixData((n, n), r[pick], c[pick],
                         g.standard_normal(int(pick.sum())))
    yield permute_locally(stencil_3d(16, 16, 8, points=27))
    # rectangular: 1100 x 900 with local columns
    rows = np.repeat(np.arange(1100), 6)
    cols = np.minimum(rows * 900 // 1100 + g.integers(0, 40, rows.size), 899)
    yield gtt.MatrixData((1100, 900), rows, cols,
                         g.standard_normal(rows.size))


def phase_kernel_b(A, A_fem):
    """Kernel B on small matrices in every type pair, then on the packed
    main-path matrix (the ``kernels`` line) and on the FEM matrix."""
    worst = {}
    for data in small_packed_matrices():
        S = gtt.Csr.from_data(data, strategy="packed")
        assert S.strategy == "packed"
        for vdtype in (torch.float32, torch.float64, torch.bfloat16,
                       torch.float16):
            xdtype = torch.float64 if vdtype == torch.float64 \
                else torch.float32
            slab, (sell, smeta) = packed_stream(S, vdtype)
            for k in (1, 3, 8, 9):
                x = torch.randn((S.shape[1], k), dtype=xdtype, device=DEV)
                err = check_stream_kernel(
                    spmv_packed.pell_spmv_cuda, sell, smeta,
                    lambda x: spmv_packed.pell_spmv_reference(
                        *slab, S.pell_meta, x), x)
                worst[str(vdtype)] = max(worst.get(str(vdtype), 0.0), err)
    say("kernel_b_small", max_rel_err=worst)
    out = time_packed("packed", A)
    time_packed("fem", A_fem)
    return out


# -- kernel C -----------------------------------------------------------------
# the random unstructured lower factors of the JAX package's packed-trisolve
# tests: (n, entries per row, reach, seed, off-diagonal scale); n = 1700
# gives an odd block count
SMALL_FACTORS = ((1500, 7, 500, 5, 0.05), (1700, 7, 600, 7, 0.04),
                 (1200, 5, 400, 9, 0.04))


def check_tri(arrays, meta, b):
    x = tri_packed.packed_trisolve_cuda(arrays, meta, b)
    torch.cuda.synchronize()
    want = tri_packed.packed_trisolve_reference(arrays, meta, b)
    assert x.shape == want.shape and x.dtype == b.dtype
    assert bool(torch.isfinite(x).all())
    err, _ = rel_err(x, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"tri_packed kernel disagrees: rel err "
                             f"{err:.3e} (b {b.dtype}, shape "
                             f"{tuple(b.shape)}, meta {dict(meta)})")
    return err


def tri_library_ms(L, b, reps):
    """cuSPARSE's triangular solve (``torch.triangular_solve`` on the
    factor as a sparse CSR tensor): the yardstick the port itself never
    calls.  Returns (ms, x), or (None, the error text) when the installed
    PyTorch refuses the sparse factor."""
    nnz = L.nnz
    S = torch.sparse_csr_tensor(L.row_ptr, L.col_idx[:nnz], L.values[:nnz],
                                size=L.shape)
    try:
        x = torch.triangular_solve(b, S, upper=False).solution
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    # not queued ahead: each call waits on the host (about 75 ms a call)
    return time_ms(lambda: torch.triangular_solve(b, S, upper=False),
                   reps), x


def inverse_check(L, arrays, nb):
    """Max relative difference of four built block inverses against an
    f64 ``numpy.linalg.inv`` of the same within-block triangles."""
    d = L.to_matrix_data()
    r, c = d.row_idx.astype(np.int64), d.col_idx.astype(np.int64)
    worst = 0.0
    for t in sorted({0, 1, nb // 2, nb - 1}):
        sel = (r // 256 == t) & (c // 256 == t)
        Lb = np.eye(256)
        Lb[r[sel] - 256 * t, c[sel] - 256 * t] = d.values[sel]
        want = np.linalg.inv(Lb)
        got = arrays["inv"][t].double().cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"built block inverses differ from the f64 "
                             f"inverse by {worst:.3e} (relative)")
    return worst


def inverse_check_tf32_on():
    """The block-inverse build after the caller turned TF32 on: four dense
    lower blocks (TF32 products would miss the f64 inverse by about 1e-4)
    must stay within 1e-5 of it, and the caller's setting must survive."""
    g = np.random.default_rng(0)
    Lb = np.tril(g.standard_normal((4, 256, 256)) * 0.1, -1)
    Lb[:, np.arange(256), np.arange(256)] = 2.0 + g.random((4, 256))
    want = np.linalg.inv(Lb)
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    torch.set_float32_matmul_precision("high")
    try:
        got = batched_lowtri_inverse(torch.from_numpy(Lb).float().to(DEV))
        got = got.double().cpu().numpy()
        kept = flags.fp32_precision
    finally:
        torch.set_float32_matmul_precision("highest")
        flags.fp32_precision = prev
    worst = max(float(np.abs(got[i] - want[i]).max() / np.abs(want[i]).max())
                for i in range(4))
    if kept != "tf32" or not worst <= 1e-5:
        raise AssertionError(f"with TF32 on, built block inverses differ "
                             f"from the f64 inverse by {worst:.3e} and the "
                             f"caller's flag reads {kept!r}")
    return worst


def tri_needed_bytes_ops(arrays, n, nb):
    """Bytes and operations the solve needs at least: the inverse entries
    on or below the diagonal in rows < n (the rest are exact zeros or rows
    past the end), the nonzero cross slots (int16 index and f32 value),
    ``nwv``, b read once and x written once."""
    rows = np.minimum(256, n - 256 * np.arange(nb))
    inv_entries = int((rows * (rows + 1) // 2).sum())
    cross = int((arrays["crossv"] != 0).sum())
    nbytes = inv_entries * 4 + cross * 6 + nb * 4 + 2 * n * 4
    return nbytes, 2 * inv_entries + 2 * cross, inv_entries, cross


def tri_chain(arrays, meta_items):
    """The plan's chain of blocks, counted from its cross slots: block t
    needs every earlier block that one of its nonzero slots reads, so the
    longest such path is the number of steps no schedule can overlap."""
    meta = dict(meta_items)
    nb, P = meta["nb"], meta["P"]
    ci = arrays["crossi"].reshape(nb, -1).long().cpu()
    live = arrays["crossv"].reshape(nb, -1).cpu() != 0
    src = torch.arange(nb)[:, None] - P + torch.div(ci, 256,
                                                    rounding_mode="floor")
    live &= src >= 0
    depth = np.ones(nb, np.int64)
    after_previous = 0
    for t in range(nb):
        deps = src[t][live[t]].unique().numpy()
        if deps.size:
            depth[t] = 1 + depth[deps].max()
            after_previous += int(deps.max() == t - 1)
    dist = (torch.arange(nb)[:, None] - src)[live]
    return dict(chain_depth=int(depth.max()),
                blocks_reading_previous=after_previous,
                cross_at_distance_1=int((dist == 1).sum()))


def phase_kernel_c(op, L):
    worst = {}
    for n, per, reach, seed, scale in SMALL_FACTORS:
        d = random_lower_factor(n, per, reach, seed, scale)
        for lower in (True, False):
            dd = d if lower else gtt.MatrixData(
                (n, n), d.col_idx.copy(), d.row_idx.copy(),
                d.values.copy()).canonical()
            arrays, meta = tri_packed.plan_packed_trisolve(dd, lower, False,
                                                           device=DEV)
            for xdtype in (torch.float32, torch.float64):
                for k in (1, 3, 8, 9):
                    b = torch.randn((n, k), dtype=xdtype, device=DEV)
                    err = check_tri(arrays, meta, b)
                    worst[str(xdtype)] = max(worst.get(str(xdtype), 0.0),
                                             err)
    say("kernel_c_small", max_rel_err=worst)

    arrays, meta_items = op.pk_arrays, op.tri_meta
    meta = dict(meta_items)
    n, nb = meta["n"], meta["nb"]
    b = torch.randn((n, 1), dtype=torch.float32, device=DEV)
    x = tri_packed.packed_trisolve_cuda(arrays, meta_items, b)
    want = tri_packed.packed_trisolve_reference(arrays, meta_items, b)
    err, scale = rel_err(x, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"tri_packed kernel disagrees on the ILU "
                             f"factor: rel err {err:.3e}")
    ms = time_ms(lambda: tri_packed.packed_trisolve_cuda(
        arrays, meta_items, b), 20, queue_ahead=True)
    plain = time_ms(lambda: tri_packed.packed_trisolve_reference(
        arrays, meta_items, b), 3)
    lib, ylib = tri_library_ms(L, b, 5)
    lib_note = (dict(library_rel_err=rel_err(ylib, want)[0]) if lib
                is not None else dict(library_error=ylib))
    inv_err = inverse_check(L, arrays, nb)
    inv_err_tf32 = inverse_check_tf32_on()
    nbytes, nops, inv_entries, cross = tri_needed_bytes_ops(arrays, n, nb)
    bms, by = bound(nbytes, nops)
    cfg = tri_packed.packed_trisolve_config(meta_items, 1)
    say("kernel_c", meta=meta, k=1, P=meta["P"], Wv=meta["Wv"], nb=nb,
        **tri_chain(arrays, meta_items), ms=ms, ms_per_block=ms / nb,
        cluster=cfg["cluster"], ring_stages=cfg["stages"],
        smem_bytes=cfg["smem_bytes"], plain_ms=plain, library_ms=lib,
        bound_ms=bms, bound_by=by, bytes=nbytes,
        inverse_entries=inv_entries, cross_entries=cross,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err,
        inverse_rel_err_vs_f64=inv_err,
        inverse_rel_err_vs_f64_tf32_on=inv_err_tf32, **lib_note)
    return dict(name="tri_packed", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/tri_packed.cu",
                replaces="ginkgo_tpu/ops/tri_packed.py:178",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


# -- main path ----------------------------------------------------------------
COUNTERS = {"dia_spmv": spmv_banded.dia_spmv_cuda,
            "dia_spmv_complex": spmv_banded.dia_spmv_complex_cuda,
            "pell_spmv": spmv_packed.pell_spmv_cuda,
            "pell_spmv_complex": spmv_packed.pell_spmv_complex_cuda,
            "tri_packed": tri_packed.packed_trisolve_cuda,
            "pair_contract_cumsum": pair_contract.pair_contract_cumsum_cuda,
            "pair_contract_onehot": pair_contract.pair_contract_onehot_cuda,
            "row_write": row_write.row_write_cuda,
            "well_spmv": spmv_windowed.well_spmv_cuda,
            "cell_spmv": spmv_chunked.cell_spmv_cuda}


def reset_counters():
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters():
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in COUNTERS.items()}


def true_rel_residual(A, b, x):
    """||b - A x|| / ||b|| in f64 (complex128 for a complex matrix) on the
    card, by the plain COO product."""
    wide = torch.complex128 if A.values.is_complex() else torch.float64
    r = b.to(wide) - coo_spmv(A.row_idx, A.col_idx, A.values.to(wide),
                              x.to(wide)[:, None], A.shape[0])[:, 0]
    return float(r.norm() / b.to(wide).norm())


def main_path(label, A, strategy, kernel):
    """Jacobi-CG on ``A`` through the port's entry points; returns every
    kernel's launches during the solve, its iterations and its x."""
    assert A.strategy == strategy, (label, A.strategy)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=DEV)
    reset_counters()
    t0 = time.perf_counter()
    res = Cg.solve(A, b, criteria=Iteration(2000) | ResidualNorm(SOLVE_TOL),
                   preconditioner=Jacobi())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    true_rel = true_rel_residual(A, b, res.x)
    iters = int(res.iterations[0])
    say(f"main_{label}", n=n, nnz=A.nnz, strategy=A.strategy,
        iterations=iters, converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches)
    if launches[kernel] <= 0:
        raise AssertionError(f"{label}: the solve never launched {kernel}")
    if not bool(res.converged.all()):
        raise AssertionError(f"{label}: CG did not converge")
    check_iterations(label, iters)
    if not (np.isfinite(true_rel) and true_rel <= TRUE_RESIDUAL_LIMIT):
        raise AssertionError(f"{label}: true relative residual {true_rel:.3e}"
                             f" > {TRUE_RESIDUAL_LIMIT}")
    return launches, iters, res.x


def check_iterations(label, iters):
    want = SLAB_ITERATIONS.get(label)
    if want is not None and iters != want:
        raise AssertionError(f"{label}: {iters} iterations, where the slab "
                             f"kernel took {want}")


def bare_solve(A, solver, tol, M=None, cap=2000):
    """``solver`` on ``A`` (without a preconditioner unless ``M``), b =
    ones, outside any counted window: its iterations, seconds, flags and
    true residual."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    t0 = time.perf_counter()
    res = solver.solve(A, b, criteria=Iteration(cap) | ResidualNorm(tol),
                       preconditioner=M)
    torch.cuda.synchronize()
    return dict(iterations=int(res.iterations[0]),
                solve_s=time.perf_counter() - t0,
                converged=bool(res.converged.all()),
                stagnated=bool(res.stagnated.any()),
                true_rel_residual=true_rel_residual(A, b, res.x))


def counted_solve(A, solver, M, tol, cap=2000):
    """``solver`` with ``M`` on ``A`` to ``tol``, b = ones, through the
    port's entry points; the kernel counts are zeroed just before the
    solve and read just after.  Returns (result, seconds, launches, true
    relative residual)."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    reset_counters()
    t0 = time.perf_counter()
    res = solver.solve(A, b, criteria=Iteration(cap) | ResidualNorm(tol),
                       preconditioner=M)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    return res, seconds, launches, true_rel_residual(A, b, res.x)


def ilu_breakdown(A, M):
    """Outside the counted window: the seconds of a second, warm solve,
    and one kernel-C launch on each factor (CUDA events), for the split of
    an iteration."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Bicgstab.solve(A, b, criteria=Iteration(1000) | ResidualNorm(ILU_TOL),
                   preconditioner=M)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    x = b[:, None]
    c_ms = {name: time_ms(lambda op=op: tri_packed.packed_trisolve_cuda(
        op.pk_arrays, op.tri_meta, x), 10)
        for name, op in (("l", M.l_solver), ("u", M.u_solver))}
    return dict(warm_solve_s=warm, kernel_c_ms=c_ms)


def check_ilu_solve(label, res, launches, true_rel, bare_iters):
    iters = int(res.iterations[0])
    if launches["pell_spmv"] <= 0:
        raise AssertionError(f"{label}: the solve never launched pell_spmv")
    if launches["tri_packed"] < 4 * iters or iters <= 0:
        raise AssertionError(f"{label}: {launches['tri_packed']} tri_packed"
                             f" launches for {iters} iterations (two ILU "
                             f"applies of two solves each per iteration)")
    if not bool(res.converged.all()):
        raise AssertionError(f"{label}: BiCGSTAB did not converge")
    if not (np.isfinite(true_rel) and true_rel <= ILU_TOL):
        raise AssertionError(f"{label}: true relative residual "
                             f"{true_rel:.3e} > {ILU_TOL}")
    if not iters < bare_iters:
        raise AssertionError(f"{label}: {iters} iterations with the "
                             f"preconditioner, {bare_iters} without")


def main_ilu(A, M):
    """Ilu-BiCGSTAB on ``A``; returns every kernel's launches during the
    solve, its iterations and those of BiCGSTAB without a preconditioner,
    which runs afterwards, outside the counted window."""
    assert A.strategy == "packed", A.strategy
    res, seconds, launches, true_rel = counted_solve(A, Bicgstab, M, ILU_TOL,
                                                     cap=1000)
    iters = int(res.iterations[0])
    bare = bare_solve(A, Bicgstab, ILU_TOL, cap=1000)
    bare_iters = bare["iterations"]
    say("main_ilu", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        iterations=iters, converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        unpreconditioned=bare, **ilu_breakdown(A, M))
    check_ilu_solve("ILU path", res, launches, true_rel, bare_iters)
    check_iterations("ilu", iters)
    return launches, iters, bare_iters


def main_ilut(A, M, parilu_iters, bare_iters):
    """Ilu(ParIlut)-BiCGSTAB on ``A``, held to what ``main_ilu`` holds."""
    res, seconds, launches, true_rel = counted_solve(A, Bicgstab, M, ILU_TOL,
                                                     cap=1000)
    iters = int(res.iterations[0])
    say("main_ilut", n=A.shape[0], iterations=iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        parilu_iterations=parilu_iters,
        unpreconditioned_iterations=bare_iters, **ilu_breakdown(A, M))
    check_ilu_solve("ILUT path", res, launches, true_rel, bare_iters)
    check_iterations("ilut", iters)
    return launches


# -- the ParILUT path -----------------------------------------------------------
def _no_planning(*args, **kw):
    raise AssertionError("the packed ParILUT plan cache missed: the kernel "
                         "phases would plan again")


def ilut_plan(A):
    """The kernel-tier packed ParILUT plan of ``A``, served by the
    single-slot plan cache that the generate filled."""
    d = A.to_matrix_data().canonical()
    return par_ilut_packed._cached_plan(
        d, "ilut", 3, ParIlut().fill_in_limit, _no_planning, device=DEV)


@contextlib.contextmanager
def plan_tally():
    """Within the block, the plan meta of every pair-contraction kernel
    launch, seen from outside the wrappers (whose counts stay the ones
    read); ``by_plan`` splits them by plan."""
    metas = []
    real = pair_contract._launch

    def seen(kernel, mode, a, b, arrs, meta_items):
        metas.append(meta_items)
        return real(kernel, mode, a, b, arrs, meta_items)

    pair_contract._launch = seen
    try:
        yield metas
    finally:
        pair_contract._launch = real


def by_plan(metas, plan):
    """Launches on each of ``plan``'s two contraction plans: the generate
    hands the kernels the plan's own meta object."""
    return {name: sum(m is plan[name]["kernel"]["meta"] for m in metas)
            for name in ("prod", "den")}


def ilut_generate(A):
    """``Ilu(factorization=ParIlut(iterations=5))`` on the card, the
    factorization counted as a main path of its own: kernel D's launches
    with their split by plan, and the stage split of the generate."""
    reset_counters()
    t0 = time.perf_counter()
    with stagetimer.collect() as st, plan_tally() as metas:
        F = ParIlut(iterations=ILUT_ITERATIONS).generate(A)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counters()
    plan = ilut_plan(A)
    split = by_plan(metas, plan)
    M = Ilu(factorization=F).generate(A)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    metas = {name: {**dict(plan[name]["kernel"]["meta"]),
                    "fill": plan[name]["kernel"]["fill"],
                    "tail": int(len(plan[name]["kernel"]["tail"][0])),
                    "pairs": int(len(plan[name]["raw"][0])),
                    "live_vregs": int(plan[name]["kernel"]["nv"].sum())}
             for name in ("prod", "den")}
    transfer = st.stages.get("transfer", 0.0)
    device = st.stages.get("device", 0.0)
    say("ilut_generate", seconds=t2 - t0, factorization_s=t1 - t0,
        host_s=t1 - t0 - transfer - device, transfer_s=transfer,
        device_s=device, trisolve_generate_s=t2 - t1, nl=plan["nl"],
        nu=plan["nu"], plans=metas, l_nnz=F.l_factor.nnz,
        u_nnz=F.u_factor.nnz, l_algorithm=M.l_solver.algorithm,
        u_algorithm=M.u_solver.algorithm,
        l_meta=dict(M.l_solver.tri_meta or ()),
        u_meta=dict(M.u_solver.tri_meta or ()), launches=launches,
        kernel_d_by_plan=split, route=F.route)
    if F.route != "packed":
        raise AssertionError(f"ParILUT generate took the {F.route} route")
    if split != ILUT_LAUNCHES or launches["pair_contract_cumsum"] != 42:
        raise AssertionError(f"ParILUT generate: kernel D launches {split} "
                             f"(total {launches['pair_contract_cumsum']}); "
                             f"the packed route takes {ILUT_LAUNCHES}")
    if not (M.l_solver.algorithm == M.u_solver.algorithm == "exact_packed"):
        raise AssertionError(f"ParILUT factors plan to "
                             f"{M.l_solver.algorithm}/{M.u_solver.algorithm}")
    for f in (F.l_factor, F.u_factor):
        if not bool(torch.isfinite(f.values[:f.nnz]).all()):
            raise AssertionError("ParILUT factors hold non-finite values")
    return F, M, plan, launches


def ilut_regenerate(A, F_first):
    """A second ``ParIlut(iterations=5)`` generate of the same matrix: the
    plan cache serves the plan and the pair streams shipped by the first
    (no planning, no repack), so the time is the values' transfer and the
    device loop.  Counted as a main path of its own; kernel D is
    deterministic, so the factors equal the first generate's."""
    reset_counters()
    t0 = time.perf_counter()
    with stagetimer.collect() as st:
        F = ParIlut(iterations=ILUT_ITERATIONS).generate(A)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    transfer = st.stages.get("transfer", 0.0)
    device = st.stages.get("device", 0.0)
    same = all(torch.equal(getattr(F, f).values, getattr(F_first, f).values)
               and torch.equal(getattr(F, f).col_idx,
                               getattr(F_first, f).col_idx)
               for f in ("l_factor", "u_factor"))
    say("ilut_regenerate", seconds=seconds, host_s=seconds - transfer - device,
        transfer_s=transfer, device_s=device, launches=launches,
        route=F.route, factors_equal_first=same)
    if F.route != "packed" or launches["pair_contract_cumsum"] != 42:
        raise AssertionError(f"ParILUT regenerate: route {F.route}, kernel D "
                             f"launches {launches['pair_contract_cumsum']}")
    if not same:
        raise AssertionError("ParILUT regenerate: factors differ from the "
                             "first generate's (kernel D is deterministic)")
    return launches


def _pattern_keys(op):
    d = op.to_matrix_data()
    return d.row_idx.astype(np.int64) * d.shape[1] + d.col_idx, d.values


def ilut_generate_onehot(A, F_ref, plan):
    """The same generate with the one-hot scatter (kernel E), counted as a
    main path of its own; its factors against those of kernel D's run: the
    two sum in other orders, so the threshold select may keep a few other
    slots and the values on the shared ones differ a little."""
    prev = pair_contract._DOT_MODE
    pair_contract._DOT_MODE = "onehot"
    try:
        reset_counters()
        t0 = time.perf_counter()
        with plan_tally() as metas:
            F = ParIlut(iterations=ILUT_ITERATIONS).generate(A)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    finally:
        pair_contract._DOT_MODE = prev
    split = by_plan(metas, plan)
    agree = {}
    for name in ("l_factor", "u_factor"):
        (k1, v1), (k2, v2) = (_pattern_keys(getattr(f, name))
                              for f in (F, F_ref))
        common, i1, i2 = np.intersect1d(k1, k2, return_indices=True)
        agree[name] = dict(
            nnz=int(k1.size), nnz_kernel_d=int(k2.size),
            shared=float(common.size / max(k2.size, 1)),
            max_rel_diff_shared=float(np.abs(v1[i1].astype(np.float64)
                                             - v2[i2]).max()
                                      / np.abs(v2).max()))
    say("ilut_generate_onehot", seconds=seconds, launches=launches,
        kernel_e_by_plan=split, against_kernel_d=agree)
    if split != ILUT_LAUNCHES or launches["pair_contract_cumsum"] != 0:
        raise AssertionError(f"one-hot ParILUT generate: kernel E launches "
                             f"{split}, kernel D "
                             f"{launches['pair_contract_cumsum']}")
    for name, a in agree.items():
        if not a["shared"] >= 0.99:
            raise AssertionError(f"one-hot ParILUT {name}: only "
                                 f"{a['shared']:.4f} of kernel D's pattern")
        if not a["max_rel_diff_shared"] <= ONEHOT_FACTOR_TOL:
            raise AssertionError(f"one-hot ParILUT {name}: values on the "
                                 f"shared slots differ by "
                                 f"{a['max_rel_diff_shared']:.3e} > "
                                 f"{ONEHOT_FACTOR_TOL}")
    return launches


# -- kernels D and E -------------------------------------------------------------
PLAN_STREAMS = ("pls", "pus", "pos", "pes", "pesp", "lq", "uq", "nv", "lbase",
                "ubase")
# the slab arrays the slab kernel D (the TPU layout) kept on the card for
# a plan, against which the pair stream's bytes are counted
SLAB_KEPT = ("pls", "pus", "pes", "pesp", "lq", "uq", "nv", "lbase", "ubase")


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pairs_in(stream):
    """The real pairs of a pair stream (its padding carries slot 1024)."""
    return int((stream["co"] < 1024).sum())


def contraction_case(cplan, seed):
    """f32 operands from a numpy seed, every slab of the kernel plan and
    its tail, its pad-free pair stream (repacked on the card, timed) and
    the raw triple on the card."""
    k = cplan["kernel"]
    meta = dict(k["meta"])
    g = np.random.default_rng(seed)
    a = torch.from_numpy(g.standard_normal(meta["n_a"]).astype(
        np.float32)).to(DEV)
    b = torch.from_numpy(g.standard_normal(meta["n_b"]).astype(
        np.float32)).to(DEV)
    arrs = {name: torch.from_numpy(k[name]).to(DEV) for name in PLAN_STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).to(DEV).long()
                         for t in k["tail"])
    repack_ms = time_ms(lambda: pair_contract.pair_stream(arrs, k["meta"]),
                        3)
    arrs["stream"] = pair_contract.pair_stream(arrs, k["meta"])
    raw = tuple(torch.from_numpy(t).to(DEV).long() for t in cplan["raw"])
    return a, b, arrs, k["meta"], raw, repack_ms


def pair_needed_bytes_ops(cplan, itemsize=4):
    """Bytes and operations the contraction needs at least, the same for
    kernels D and E: each planned pair's three int16 indices (6 B; the
    padding slots of the streams are the layout's, not the function's),
    the live vregs' window starts, the per-tile tables, a and b read once,
    y written once, and the tail's indices (12 B a pair; its values are
    reads of a and b); a multiply and an add a pair."""
    k = cplan["kernel"]
    meta = dict(k["meta"])
    live = int(k["nv"].sum())
    pairs = len(cplan["raw"][0])
    tail = len(k["tail"][0])
    nbytes = ((pairs - tail) * 6 + live * 8 + meta["T"] * 12
              + (meta["n_a"] + meta["n_b"] + meta["n_out"]) * itemsize
              + tail * 12)
    return nbytes, 2 * pairs


def check_pair(name, mode, cplan, seed):
    """One kernel on one plan: error against the plain version and the
    f64 oracle, kernel D twice bit for bit, then times.  Returns the
    phase's fields."""
    a, b, arrs, meta, raw, repack_ms = contraction_case(cplan, seed)
    n_out = dict(meta)["n_out"]
    prev = pair_contract._DOT_MODE
    pair_contract._DOT_MODE = mode
    try:
        fn = pair_contract.pair_contract_planned_cuda
        y = fn(a, b, arrs, meta)
        torch.cuda.synchronize()
        plain = pair_contract.pair_contract_planned_reference(a, b, arrs,
                                                              meta)
        oracle = pair_contract.pair_contract_reference(a.double(),
                                                       b.double(), *raw,
                                                       n_out)
        assert y.shape == plain.shape == (n_out,) and y.dtype == a.dtype
        assert bool(torch.isfinite(y).all())
        if mode == "cumsum_batched" and not torch.equal(y, fn(a, b, arrs,
                                                              meta)):
            raise AssertionError(f"{name}: two runs differ (kernel D is "
                                 f"deterministic)")
        err_plain, scale = rel_err(y, plain)
        err_oracle, _ = rel_err(y, oracle)
        tol = PAIR_TOL[name]
        if not (err_plain <= tol and err_oracle <= tol):
            raise AssertionError(f"{name} disagrees: rel err {err_plain:.3e}"
                                 f" to its plain version, {err_oracle:.3e} "
                                 f"to the f64 oracle (tol {tol})")
        ms = time_ms(lambda: fn(a, b, arrs, meta), 20, queue_ahead=True)
        plain_ms = time_ms(lambda: pair_contract.pair_contract_planned_reference(
            a, b, arrs, meta), 3)
    finally:
        pair_contract._DOT_MODE = prev
    lib = time_ms(lambda: pair_contract.pair_contract_reference(
        a, b, *raw, n_out), 10, queue_ahead=True)
    nbytes, nops = pair_needed_bytes_ops(cplan)
    bms, by = bound(nbytes, nops)
    st = arrs["stream"]
    live = int(cplan["kernel"]["nv"].sum())
    slab_bytes = tensor_bytes(arrs[key] for key in SLAB_KEPT)
    stream_bytes = tensor_bytes(st.values())
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bms,
                bound_by=by, bytes=nbytes, pairs=nops // 2,
                stream_pairs=pairs_in(st), stream_slots=st["cl"].numel(),
                live_vregs=live, live_vreg_fill=pairs_in(st) / (live * 1024),
                index_stream_bytes=tensor_bytes(st[key] for key in
                                                ("cl", "cu", "co")),
                stream_bytes=stream_bytes, slab_bytes=slab_bytes,
                device_bytes_freed=slab_bytes - stream_bytes,
                repack_ms=repack_ms,
                effective_GBps=nbytes / (ms * 1e-3) / 1e9,
                max_abs_err=err_plain * scale, max_rel_err=err_plain,
                max_rel_err_vs_f64_oracle=err_oracle)


def phase_kernels_de(plan):
    """Kernels D and E at the ParILUT path's product and denominator
    plans.  The ``kernels`` line carries the product plan's numbers (23 of
    the 42 launches of a generate, and most of its time)."""
    out = []
    for name, mode, src_line in (
            ("pair_contract_cumsum", "cumsum_batched", 535),
            ("pair_contract_onehot", "onehot", 412)):
        fields = {pname: check_pair(name, mode, plan[pname], seed)
                  for pname, seed in (("prod", 31), ("den", 32))}
        say("kernel_d" if mode == "cumsum_batched" else "kernel_e",
            name=name, plans=fields)
        out.append(dict(name=name, route="cuda",
                        source="ginkgo_tpu_torch/ops/csrc/pair_contract.cu",
                        replaces=f"ginkgo_tpu/ops/pair_contract.py:{src_line}",
                        **{key: fields["prod"][key] for key in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}))
    return out


def small_ilu_solves_match_cpu():
    """Ilu/Ic-preconditioned solves on the card against the same solves
    on the host."""
    fem = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.random.default_rng(2).standard_normal((4096, 3))
    cases = (
        # f32 ParILU factors on both devices (index_add_ sums in another
        # order on the card), both solves on kernel C / its plain version
        ("ilu_f32", fem, np.float32, Bicgstab, "packed",
         lambda: Ilu(factorization=ParIlu(5)), 1e-5),
        ("ic_f64", stencil_3d(12, points=27), np.float64, Cg,
         "automatical", Ic, 1e-10),
        ("ilu_f64", fem, np.float64, Bicgstab, "automatical", Ilu, 1e-10))
    for label, data, dtype, solver, strategy, precond, tol in cases:
        rhs = b[:data.shape[0]].astype(dtype)
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, dtype=dtype, strategy=strategy,
                                  device=dev)
            M = precond().generate(A)
            res = solver.solve(A, torch.from_numpy(rhs).to(dev),
                               criteria=Iteration(300) | ResidualNorm(tol),
                               preconditioner=M)
            out.append(((M.l_solver.algorithm, M.u_solver.algorithm),
                        res.iterations.cpu(), res.converged.cpu(),
                        res.x.cpu()))
        (ag, ig, cg, xg), (ac, ic, cc, xc) = out
        assert bool(cg.all()) and bool(cc.all()), (label, cg, cc)
        if label == "ilu_f32":
            assert ag == ac == ("exact_packed", "exact_packed"), (ag, ac)
            assert int((ig - ic).abs().max()) <= 1, (ig, ic)
            err, _ = rel_err(xg, xc)
            assert err <= 1e-4, (label, err)
        else:
            # the card takes #levels jacobi sweeps where the off part
            # plans to a fast layout; the host always the level solve
            if label == "ic_f64":
                assert ag == ac == ("exact", "exact"), (ag, ac)
            assert torch.equal(ig, ic), (label, ig, ic)
            torch.testing.assert_close(xg, xc, rtol=1e-9, atol=1e-9)
        say("small_solve", case=label, card_algorithms=ag,
            host_algorithms=ac, card_iterations=ig.tolist(),
            host_iterations=ic.tolist())


def _assert_factors_match(label, Fg, Fc, rtol):
    for name in ("l_factor", "u_factor"):
        g = getattr(Fg, name).to_matrix_data()
        c = getattr(Fc, name).to_matrix_data()
        if not (np.array_equal(g.row_idx, c.row_idx)
                and np.array_equal(g.col_idx, c.col_idx)):
            raise AssertionError(f"{label} {name}: card and host patterns "
                                 f"differ ({g.nnz} vs {c.nnz} entries)")
        err = float(np.abs(g.values - c.values).max()
                    / np.abs(c.values).max())
        if not err <= rtol:
            raise AssertionError(f"{label} {name}: card and host values "
                                 f"differ by {err:.3e} (relative)")


def small_ilut_match_cpu():
    """Packed ParILUT/ParICT on small matrices, card (kernel D, f64
    instantiation) against host (the raw triples); then an
    Ilu(ParIlut)-BiCGSTAB f32 solve on both.  ParICT runs on symmetric
    matrices (the FEM case's packed ParICT plan declines on the kernel
    tier, and a nonsymmetric matrix amplifies rounding through its square
    roots)."""
    fem = build_matrix_data({"fem": 4096, "offscale": 1.2})
    band = random_banded(3000, 40, 8, seed=1)
    cases = (("parilut_fem", fem, ParIlut), ("parilut_band", band, ParIlut),
             ("parict_band", symmetric_part(band), ParIct),
             ("parict_band_narrow",
              symmetric_part(random_banded(800, 10, 5, seed=5)), ParIct))
    for label, data, P in cases:
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, dtype=np.float64, device=dev)
            reset_counters()
            F = P(iterations=3, algorithm="packed").generate(A)
            out.append((F, read_counters()["pair_contract_cumsum"]))
        (Fg, ng), (Fc, nc) = out
        if ng <= 0 or nc != 0:
            raise AssertionError(f"{label}: kernel D launched {ng} times on "
                                 f"the card and {nc} on the host")
        _assert_factors_match(label, Fg, Fc, 1e-10)
        say("small_parilut", case=label, n=data.shape[0],
            kernel_d_launches=ng, l_nnz=Fg.l_factor.nnz,
            u_nnz=Fg.u_factor.nnz)
    b = np.random.default_rng(3).standard_normal((4096, 3)).astype(
        np.float32)
    out = []
    for dev in (DEV, torch.device("cpu")):
        A = gtt.Csr.from_data(fem, dtype=np.float32, strategy="packed",
                              device=dev)
        M = Ilu(factorization=ParIlut(iterations=5,
                                      algorithm="packed")).generate(A)
        res = Bicgstab.solve(A, torch.from_numpy(b).to(dev),
                             criteria=Iteration(300) | ResidualNorm(1e-5),
                             preconditioner=M)
        out.append(((M.l_solver.algorithm, M.u_solver.algorithm),
                    res.iterations.cpu(), res.converged.cpu(), res.x.cpu()))
    (ag, ig, cg, xg), (ac, ic, cc, xc) = out
    assert bool(cg.all()) and bool(cc.all()), (cg, cc)
    assert ag == ac == ("exact_packed", "exact_packed"), (ag, ac)
    assert int((ig - ic).abs().max()) <= 1, (ig, ic)
    say("small_solve", case="ilut_f32", card_algorithms=ag,
        host_algorithms=ac, card_iterations=ig.tolist(),
        host_iterations=ic.tolist(), x_rel_diff=rel_err(xg, xc)[0])


# -- kernel F -------------------------------------------------------------------
ROW_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
              torch.int16, torch.int8, torch.complex64, torch.complex128)
# rounds of kernel F and copy_ timed in turns (odd: each median is one of
# the samples)
F_ROUNDS = 5
# n = 1003 leaves ragged ends and rows that start off 16-byte boundaries
ROW_SHAPES = ((13, 1003), (13, 1003, 3), (16, 4096))


def random_tensor(shape, dtype):
    if dtype.is_complex:
        return torch.randn(shape, device=DEV, dtype=dtype)
    if dtype.is_floating_point:
        return torch.randn(shape, device=DEV).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, device=DEV, dtype=dtype)


def check_row_write(store, rows):
    """Write ``rows`` ({row index: tensor}) into ``store`` with kernel F:
    bit for bit the plain ``copy_``, the other rows untouched, the store
    written in place, nothing allocated."""
    want = store.clone()
    torch.cuda.synchronize()
    ptr, mem = store.data_ptr(), torch.cuda.memory_allocated()
    for i, row in rows.items():
        if row_write.row_write_cuda(store, i, row) is not store:
            raise AssertionError("kernel F returned another tensor")
        want[i].copy_(row)
    torch.cuda.synchronize()
    if store.data_ptr() != ptr or torch.cuda.memory_allocated() > mem:
        raise AssertionError(f"kernel F moved the store or allocated "
                             f"({torch.cuda.memory_allocated() - mem} B)")
    if not torch.equal(store.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"kernel F differs from copy_ on a "
                             f"{store.dtype} store of shape "
                             f"{tuple(store.shape)}")


def phase_kernel_f(n):
    for dtype in ROW_DTYPES:
        for shape in ROW_SHAPES:
            store = random_tensor(shape, dtype)
            check_row_write(store, {i: random_tensor(shape[1:], dtype)
                                    for i in (0, 6, shape[0] - 1)})
    say("kernel_f_small", dtypes=[str(d) for d in ROW_DTYPES],
        shapes=ROW_SHAPES, bit_exact=True)

    # one GMRES row at the main path's n; the timed launches rotate over 7
    # rows of the store and 4 sources (over 130 MB), so each launch finds
    # its bytes outside the 50 MB L2 as the solver's writes do
    store = torch.zeros((8, n), dtype=torch.float32, device=DEV)
    srcs = torch.randn((4, n), dtype=torch.float32, device=DEV)
    check_row_write(store, {1: srcs[0]})
    err = float((store[1] - srcs[0]).abs().max())
    turn = iter(range(1 << 30))

    def rotating(write):
        def launch():
            j = next(turn)
            write(1 + j % 7, srcs[j % 4])
        return launch

    # the kernel and copy_ in turns, the order swapped each round: their
    # difference against the spread of each
    writers = {"kernel": lambda i, r: row_write.row_write_cuda(store, i, r),
               "copy_": lambda i, r: store[i].copy_(r)}
    turns = {name: [] for name in writers}
    for rnd in range(F_ROUNDS):
        for name in sorted(writers, reverse=bool(rnd % 2)):
            turns[name].append(time_ms(rotating(writers[name]), 20,
                                       queue_ahead=True))
    ms, lib = (statistics.median(turns[name]) for name in ("kernel", "copy_"))
    plain = time_ms(rotating(
        lambda i, r: row_write.row_write_reference(store, i, r)), 20,
        queue_ahead=True)
    nbytes = 2 * n * 4
    bms, by = bound(nbytes, 0)
    say("kernel_f", n=n, dtype="float32", ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=bms, bound_by=by, bytes=nbytes,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9, max_abs_err=err,
        ms_turns=turns["kernel"], library_ms_turns=turns["copy_"])
    return dict(name="row_write", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/row_write.cu",
                replaces="ginkgo_tpu/solver/krylov_basis.py:48",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


# -- the GMRES path ---------------------------------------------------------------
@contextlib.contextmanager
def arnoldi_tally():
    """Within the block, the Arnoldi steps and the restarts of GMRES's
    two-level loop, counted by wrapping the step and restart functions
    that the solver hands ``run_restarted_loop``."""
    tally = {"arnoldi_steps": 0, "restarts": 0}
    real = gmres_mod.run_restarted_loop

    def counted(inner_step, cycle_done, restart_fn, *args, **kw):
        def step(state, active):
            tally["arnoldi_steps"] += 1
            return inner_step(state, active)

        def restart(state, sel):
            tally["restarts"] += 1
            return restart_fn(state, sel)

        return real(step, cycle_done, restart, *args, **kw)

    gmres_mod.run_restarted_loop = counted
    try:
        yield tally
    finally:
        gmres_mod.run_restarted_loop = real


def main_gmres(A, storage=None):
    """GMRES(100) (``storage`` None) or CB-GMRES on ``A``, b = ones,
    through the port's entry points; returns every kernel's launches
    during the solve."""
    label = "main_gmres" if storage is None else f"main_cb_gmres_{storage}"
    solver, kw = ((Gmres, {}) if storage is None
                  else (CbGmres, dict(storage_precision=storage)))
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with arnoldi_tally() as tally:
        reset_counters()
        t0 = time.perf_counter()
        res = solver.solve(A, b, criteria=Iteration(1000) | ResidualNorm(
            GMRES_TOL, baseline="rhs_norm"), krylov_dim=GMRES_KRYLOV_DIM,
            ortho="cgs2", **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    true_rel = true_rel_residual(A, b, res.x)
    iters = int(res.iterations[0])
    # restart_fields writes row 0 once before the loop and once in each
    # restart; each Arnoldi step writes row j + 1
    writes = tally["arnoldi_steps"] + tally["restarts"] + 1
    say(label, n=A.shape[0], storage=storage or "keep",
        krylov_dim=GMRES_KRYLOV_DIM, iterations=iters, **tally,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        expected_row_writes=writes, peak_memory_GB=peak / 1e9)
    if launches["dia_spmv"] <= 0:
        raise AssertionError(f"{label}: the solve never launched dia_spmv")
    if launches["row_write"] != writes:
        raise AssertionError(f"{label}: {launches['row_write']} row_write "
                             f"launches for {tally['arnoldi_steps']} Arnoldi"
                             f" steps and {tally['restarts'] + 1} "
                             f"restart_fields calls")
    if not bool(res.converged.all()) or bool(res.stagnated.any()):
        raise AssertionError(f"{label}: GMRES did not converge "
                             f"(stagnated {bool(res.stagnated.any())})")
    if not (np.isfinite(true_rel) and true_rel <= GMRES_TOL):
        raise AssertionError(f"{label}: true relative residual "
                             f"{true_rel:.3e} > {GMRES_TOL}")
    return launches


def gmres_tf32():
    """GMRES(30) on a small f32 stencil with TF32 turned on by the caller:
    the projection's products stay full f32, so the iterations and x equal
    those of a run without it, and the caller's setting survives.  The
    same run with the guard taken out is reported beside it."""
    A = gtt.Csr.from_data(stencil_3d(32, points=27), dtype=np.float32)
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    guard = gmres_mod._full_f32_matmul

    def run():
        res = Gmres.solve(A, b, criteria=Iteration(500) | ResidualNorm(1e-4),
                          krylov_dim=30)
        torch.cuda.synchronize()
        return int(res.iterations[0]), res.x, flags.fp32_precision

    try:
        it0, x0, _ = run()
        flags.fp32_precision = "tf32"
        it1, x1, kept = run()
        gmres_mod._full_f32_matmul = contextlib.nullcontext
        it2, x2, _ = run()
    finally:
        gmres_mod._full_f32_matmul = guard
        flags.fp32_precision = prev
    err = rel_err(x1, x0)[0]
    say("gmres_tf32", n=A.shape[0], iterations=it0, iterations_tf32=it1,
        x_rel_diff=err, caller_flag_after=kept,
        unguarded_iterations_tf32=it2,
        unguarded_x_rel_diff=rel_err(x2, x0)[0])
    if kept != "tf32" or it1 != it0 or not err <= 1e-5:
        raise AssertionError(f"GMRES under TF32: {it1} iterations against "
                             f"{it0}, x differs by {err:.3e}, the caller's "
                             f"flag reads {kept!r}")


def small_gmres_match_cpu():
    """f64 CB-GMRES(20) on a small FEM matrix, two right-hand sides, on the
    card against the host: equal iterations, converged and stagnated, x to
    1e-10."""
    data = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.random.default_rng(4).standard_normal((4096, 2))
    for storage in ("keep", "integer"):
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, device=dev)
            res = CbGmres.solve(A, torch.from_numpy(b).to(dev),
                                criteria=Iteration(400) | ResidualNorm(1e-10),
                                krylov_dim=20, storage_precision=storage)
            out.append((res.iterations.cpu(), res.converged.cpu(),
                        res.stagnated.cpu(), res.x.cpu()))
        (ig, cg, sg, xg), (ic, cc, sc, xc) = out
        assert bool(cg.all()), (storage, cg)
        assert torch.equal(ig, ic) and torch.equal(cg, cc) and \
            torch.equal(sg, sc), (storage, ig, ic, cg, cc, sg, sc)
        torch.testing.assert_close(xg, xc, rtol=1e-10, atol=1e-10)
        say("small_gmres", storage=storage, iterations=ig.tolist(),
            x_rel_diff=rel_err(xg, xc)[0])


# -- kernels G and H ----------------------------------------------------------------
ATTIC = {"well_spmv": (spmv_windowed, "plan_windowed_layout",
                       "ginkgo_tpu/ops/attic/spmv_windowed.py:200"),
         "cell_spmv": (spmv_chunked, "plan_chunked_layout",
                       "ginkgo_tpu/ops/attic/spmv_chunked.py:202")}


def attic_plans(d):
    """Both attic layouts of ``d`` (f32 values), on the card."""
    vals = d.values.astype(np.float32)
    plans = {}
    for name, (mod, planner, _) in ATTIC.items():
        t0 = time.perf_counter()
        layout, tail, stats = getattr(mod, planner)(d, vals)
        plans[name] = dict(mod=mod, t=mod.upload(layout, tail, DEV),
                           stats=stats, plan_s=time.perf_counter() - t0)
    return plans


def main_attic(plans, m):
    """The attic path: each layout's own apply (kernel plus COO tail) at
    k = 1 and k = 3; returns the launches and the products."""
    xs = [torch.randn((m, k), dtype=torch.float32, device=DEV)
          for k in (1, 3)]
    reset_counters()
    ys = {name: [getattr(p["mod"], f"{name}_apply")(p["t"], x) for x in xs]
          for name, p in plans.items()}
    launches = read_counters()
    for name in plans:
        if launches[name] <= 0:
            raise AssertionError(f"the attic apply never launched {name}")
    return launches, xs, ys


def kernel_args(t):
    """The layout arguments of a kernel's wrapper: the slab's compact
    stream (G's and H's alike)."""
    return [t["sell"], t["sell_meta"]]


def slab_plain(name, t):
    """The slab's own plain version, as a function of x."""
    mod = ATTIC[name][0]
    fn = getattr(mod, f"{name}_reference")
    return lambda x: fn(*(t[key] for key in mod.ARRAYS), t["meta"], x)


def stream_builder(name):
    """The repack of a slab, taking the slab's arrays as ``mod.ARRAYS``
    orders them (G's stream reads no q0: it serves the TPU only)."""
    if name == "well_spmv":
        return lambda vals, c16, q0, xbase_row, meta: \
            spmv_sell.sell_from_windowed(vals, c16, xbase_row, meta)
    return spmv_sell.sell_from_chunked


def phase_kernels_gh(plans, xs, ys, A):
    """Kernels G and H on the ILU system's matrix and on small random
    matrices, against their plain versions (for H, the stream's and the
    slab's) and an f64 product."""
    n, m = A.shape
    d64 = A.values.double()
    want = [coo_spmv(A.row_idx, A.col_idx, d64, x.double(), n) for x in xs]
    small_plans = [(data, attic_plans(data))
                   for data in small_packed_matrices()]
    out = []
    for name, p in plans.items():
        mod, t = p["mod"], p["t"]
        args = kernel_args(t)
        kernel = getattr(mod, f"{name}_cuda")
        plain_fn = registry.lookup(name, "cpu")
        slab_fn = slab_plain(name, t)
        worst = 0.0
        for x, y, w in zip(xs, ys[name], want):
            errs = [rel_err(y, w)[0]] + [
                rel_err(y, mod.add_tail(f(x), t["tail"], x))[0]
                for f in (lambda x: plain_fn(*args, x), slab_fn)]
            worst = max(worst, *errs)
            if not max(errs) <= ATTIC_TOL:
                raise AssertionError(f"{name} disagrees at k={x.shape[1]}: "
                                     f"rel errs {errs} to the f64 product "
                                     f"and the plain versions")
        small = 0.0
        for data, splans in small_plans:
            st = splans[name]["t"]
            sargs = kernel_args(st)
            for k in (1, 3, 8, 9):
                x = torch.randn((data.shape[1], k), dtype=torch.float32,
                                device=DEV)
                y = kernel(*sargs, x)
                torch.cuda.synchronize()
                e = max(rel_err(y, plain_fn(*sargs, x))[0],
                        rel_err(y, slab_plain(name, st)(x))[0])
                small = max(small, e)
                if not e <= ATTIC_TOL:
                    raise AssertionError(f"{name} disagrees on a small "
                                         f"matrix: rel err {e:.3e}")
        x = xs[0]
        y = kernel(*args, x)
        err, scale = rel_err(y, plain_fn(*args, x))
        ms = time_ms(lambda: kernel(*args, x), 20, queue_ahead=True)
        plain_ms = time_ms(lambda: plain_fn(*args, x), 3)
        lib, _ = library_ms(A, x, 20)
        nbytes = stream_needed_bytes(p["stats"]["ell_nnz"], 4, n, m)
        bms, by = bound(nbytes, 2 * p["stats"]["ell_nnz"])
        slab = [t[key] for key in mod.ARRAYS]
        extra = dict(**stream_fields(t["sell"], t["sell_meta"], slab),
                     repack_ms=repack(stream_builder(name), slab, t["meta"],
                                      (t["sell"], t["sell_meta"])),
                     slab_max_rel_err=rel_err(y, slab_fn(x))[0])
        say("kernel_g" if name == "well_spmv" else "kernel_h", name=name,
            **p["stats"], plan_s=p["plan_s"], meta=dict(t["meta"]), **extra,
            k=1, ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bms,
            bound_by=by, bytes=nbytes,
            effective_GBps=nbytes / (ms * 1e-3) / 1e9,
            max_abs_err=err * scale, max_rel_err=err,
            max_rel_err_apply=worst, max_rel_err_small=small)
        out.append(dict(name=name, route="cuda",
                        source="ginkgo_tpu_torch/ops/csrc/sell_spmv.cu",
                        replaces=ATTIC[name][2], max_abs_err=err * scale,
                        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=lib))
    return out


def small_solves_match_cpu():
    """f64 Jacobi-CG on the card against the same solve on the host."""
    for data in (stencil_3d(12, points=27),
                 permute_locally(stencil_3d(16, 16, 8, points=27))):
        b = np.random.default_rng(1).standard_normal((data.shape[0], 3))
        crit = Iteration(500) | ResidualNorm(1e-10)
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, device=dev)
            res = Cg.solve(A, torch.from_numpy(b).to(dev), criteria=crit,
                           preconditioner=Jacobi())
            out.append((A.strategy, res.iterations.cpu(),
                        res.converged.cpu(), res.x.cpu()))
        (sg, ig, cg, xg), (sc, ic, cc, xc) = out
        assert sg == sc and torch.equal(ig, ic) and torch.equal(cg, cc), \
            (sg, ig, cg, sc, ic, cc)
        assert bool(cg.all())
        torch.testing.assert_close(xg, xc, rtol=1e-9, atol=1e-9)
        say("small_f64_solve", strategy=sg, iterations=ig.tolist())


# -- the DIA ParILUT/ParICT path and block Jacobi --------------------------
def check_solve(label, res, launches, true_rel, tol, kernels):
    iters = int(res.iterations[0])
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: the solve never launched {name}")
    if not bool(res.converged.all()) or iters <= 0:
        raise AssertionError(f"{label}: the solve did not converge")
    if not (np.isfinite(true_rel) and true_rel <= tol):
        raise AssertionError(f"{label}: true relative residual "
                             f"{true_rel:.3e} > {tol}")


def main_dia(label, A, P, precond, solver):
    """``precond(P(iterations=5))`` generated on the card (``auto``: the
    DIA loop must take it) with its stagetimer split and the trisolve
    algorithms its factors get, then ``solver`` to ``DIA_TOL`` in fewer
    iterations than without the preconditioner.  The counted window is the
    solve (the generate is plain tensor code: no kernel of the port)."""
    t0 = time.perf_counter()
    with stagetimer.collect() as st:
        F = P(iterations=DIA_ITERATIONS).generate(A)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    M = precond(factorization=F).generate(A)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    transfer = st.stages.get("transfer", 0.0)
    device = st.stages.get("device", 0.0)
    algorithms = (M.l_solver.algorithm, M.u_solver.algorithm)
    say(f"{label}_generate", route=F.route, seconds=t2 - t0,
        factorization_s=t1 - t0, host_s=t1 - t0 - transfer - device,
        transfer_s=transfer, device_s=device, trisolve_generate_s=t2 - t1,
        l_nnz=F.l_factor.nnz, u_nnz=F.u_factor.nnz, a_nnz=A.nnz,
        l_algorithm=algorithms[0], u_algorithm=algorithms[1],
        peak_device_GB=torch.cuda.max_memory_allocated() / 1e9)
    if F.route != "dia":
        raise AssertionError(f"{label}: the generate took the {F.route} "
                             f"route, not dia")
    for f in (F.l_factor, F.u_factor):
        if not bool(torch.isfinite(f.values[:f.nnz]).all()):
            raise AssertionError(f"{label}: factors hold non-finite values")
    res, seconds, launches, true_rel = counted_solve(A, solver, M, DIA_TOL)
    iters = int(res.iterations[0])
    bare = bare_solve(A, solver, DIA_TOL)
    say(label, n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        solver=solver.__name__, iterations=iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        unpreconditioned=bare,
        # where f32 stalls on A: the same solves to 1e-5
        to_1e_5=bare_solve(A, solver, 1e-5, M),
        to_1e_5_unpreconditioned=bare_solve(A, solver, 1e-5))
    bare = bare["iterations"]
    kernels = ["dia_spmv"] + ["tri_packed"] * ("exact_packed" in algorithms)
    check_solve(label, res, launches, true_rel, DIA_TOL, kernels)
    if not iters < bare:
        raise AssertionError(f"{label}: {iters} iterations with the "
                             f"preconditioner, {bare} without")
    return launches


def main_block_jacobi(label, A, scalar_iters=None, **kw):
    """``Cg`` with ``Jacobi(max_block_size=8, **kw)`` on ``A`` to
    ``SOLVE_TOL`` (the counted window is the solve: the generate launches
    no kernel of the port), the apply timed on its own."""
    t0 = time.perf_counter()
    M = Jacobi(max_block_size=BLOCK_SIZE, **kw).generate(A)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    res, seconds, launches, true_rel = counted_solve(A, Cg, M, SOLVE_TOL)
    iters = int(res.iterations[0])
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    extra = {}
    if hasattr(M, "storage_fraction_reduced"):
        extra["fraction_reduced"] = float(M.storage_fraction_reduced)
        extra["reduced_dtype"] = str(M.inv_reduced.dtype)
    say(label, n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        operator=type(M).__name__, block_size=BLOCK_SIZE, **extra,
        generate_s=generate_s, iterations=iters,
        scalar_jacobi_iterations=scalar_iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        apply_ms=time_ms(lambda: M.apply(b), 20, queue_ahead=True),
        spmv_ms=time_ms(lambda: A.apply(b), 20, queue_ahead=True),
        true_rel_residual=true_rel, launches=launches)
    check_solve(label, res, launches, true_rel, TRUE_RESIDUAL_LIMIT,
                ["dia_spmv"])
    return launches


def small_dia_and_block_jacobi_match_cpu():
    """f64 on the card against the port's CPU run: the DIA ParILUT and
    ParICT factors (forced ``dia``) at nx = 8, and block-Jacobi CG (block
    size 4, the adaptive storage, natural blocks)."""
    data = stencil_3d(8, points=27)
    for label, P in (("parilut_dia", ParIlut), ("parict_dia", ParIct)):
        out = [P(iterations=3, algorithm="dia").generate(
            gtt.Csr.from_data(data, dtype=np.float64, device=dev))
            for dev in (DEV, torch.device("cpu"))]
        if not out[0].route == out[1].route == "dia":
            raise AssertionError(f"{label}: routes {out[0].route}/"
                                 f"{out[1].route}")
        _assert_factors_match(label, *out, 1e-10)
        say("small_dia", case=label, l_nnz=out[0].l_factor.nnz,
            u_nnz=out[0].u_factor.nnz)
    b = np.random.default_rng(5).standard_normal((1728, 2))
    for label, data, kw in (
            ("block4", stencil_3d(12, points=27), dict(max_block_size=4)),
            ("adaptive8", stencil_3d(12, points=27),
             dict(max_block_size=8, storage_optimization="auto")),
            ("natural4", stencil_3d(12, points=7),
             dict(max_block_size=4, natural_blocks=True))):
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, dtype=np.float64, device=dev)
            res = Cg.solve(A, torch.from_numpy(b).to(dev),
                           criteria=Iteration(500) | ResidualNorm(1e-10),
                           preconditioner=Jacobi(**kw))
            out.append((res.iterations.cpu(), res.converged.cpu(),
                        res.x.cpu()))
        (ig, cg, xg), (ic, cc, xc) = out
        assert bool(cg.all()) and torch.equal(ig, ic) and \
            torch.equal(cg, cc), (label, ig, ic)
        torch.testing.assert_close(xg, xc, rtol=1e-9, atol=1e-9)
        say("small_block_jacobi", case=label, iterations=ig.tolist())


# -- the complex path ----------------------------------------------------------------
def shifted(data):
    """A = P (1 + 0.02i) + 0.5i I of the stencil P, in complex64."""
    diag = data.row_idx == data.col_idx
    vals = data.values * (1 + 0.02j) + 0.5j * diag
    return gtt.MatrixData(data.shape, data.row_idx, data.col_idx,
                          vals.astype(np.complex64))


def hermitian(data):
    """H = P + 1.02 I + 0.02i (U - U^T) of the symmetric stencil P, U its
    strict upper triangle: (U - U^T)[r, c] = sign(c - r) P[r, c]."""
    r, c = data.row_idx, data.col_idx
    vals = (data.values + 1.02 * (r == c)
            + 0.02j * np.sign(c.astype(np.int64) - r) * data.values)
    return gtt.MatrixData(data.shape, r, c, vals.astype(np.complex64))


def complexify(vals, vdtype, seed):
    """Real values ``vals`` (a tensor on the card) as ``vdtype``: for a
    complex type with a random imaginary part on the nonzero entries, and
    every third entry purely imaginary."""
    if not vdtype.is_complex:
        return vals.to(vdtype)
    g = torch.Generator(device=DEV).manual_seed(seed)
    im = torch.randn(vals.shape, generator=g, dtype=torch.float64,
                     device=DEV) * (vals != 0)
    keep = torch.arange(vals.numel(), device=DEV).reshape(vals.shape) % 3
    return torch.complex(vals.double() * (keep != 0), im).to(vdtype)


def check_complex(fn, plains, x):
    """One call of a complex kernel wrapper ``fn(x)`` against each plain
    version in ``plains`` on ``x`` cast to the result type; returns the
    largest relative error."""
    y = fn(x)
    torch.cuda.synchronize()
    assert y.is_complex() and bool(torch.isfinite(torch.view_as_real(y)).all())
    err = 0.0
    for plain in plains:
        want = plain(x.to(y.dtype))
        assert y.shape == want.shape
        err = max(err, rel_err(y, want)[0])
    tol = TOL[y.dtype]
    if not err <= tol:
        raise AssertionError(f"a complex kernel disagrees: rel err {err:.3e}"
                             f" > {tol} (x {x.dtype}, shape "
                             f"{tuple(x.shape)})")
    return err


def timed_complex_kernel(label, name, source, replaces, fn, plain, A, x,
                         nbytes, entries):
    """A complex kernel at k = 1 on a main-path matrix: checked against its
    plain version, timed beside its bound, the plain version and cuSPARSE;
    returns its entry of the ``kernels`` line."""
    y = fn(x)
    want = plain(x)
    err, scale = rel_err(y, want)
    if not err <= TOL[torch.complex64]:
        raise AssertionError(f"{name} disagrees on the {label} matrix: rel "
                             f"err {err:.3e}")
    ms = time_ms(lambda: fn(x), 50, queue_ahead=True)
    plain_ms = time_ms(lambda: plain(x), 5)
    lib, ylib = library_ms(A, x, 20)
    # one complex multiply-add an entry: 4 multiplies and 4 adds
    bms, by = bound(nbytes, 8 * entries)
    say(label, name=name, n=A.shape[0], k=1, entries=entries, ms=ms,
        plain_ms=plain_ms, library_ms=lib, bound_ms=bms, bound_by=by,
        bytes=nbytes, effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err,
        library_rel_err=rel_err(ylib, want)[0])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err * scale, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib)


def phase_kernel_a_complex(A):
    """Kernel A's complex instantiation on small random banded matrices in
    every type pair, then on the complex main-path matrix."""
    worst = {}
    for n, offsets in ((1000, (-1, 0, 1)),
                       (5000, (-130, -129, -128, -1, 0, 1, 128, 129, 130)),
                       (700, (0,))):
        for vdtype, xdtype in COMPLEX_PAIRS:
            meta, dvb = banded_case(n, offsets, torch.float64, seed=n)
            dvb = complexify(dvb, vdtype, seed=n)
            for k in (1, 3, 8, 9):
                x = random_tensor((n, k), xdtype)
                err = check_complex(
                    lambda x: spmv_banded.dia_spmv_complex_cuda(
                        offsets, dvb, meta, x),
                    [lambda x: spmv_banded.dia_spmv_reference(
                        offsets, dvb, meta, x)], x)
                key = f"{vdtype}/{xdtype}"
                worst[key] = max(worst.get(key, 0.0), err)
    say("kernel_a_complex_small", max_rel_err=worst)

    n = A.shape[0]
    offsets, meta = A.diag_offsets, dict(A.band_meta)
    entries = int((A.diag_values != 0).sum())
    return timed_complex_kernel(
        "kernel_a_complex", "dia_spmv_complex",
        "ginkgo_tpu_torch/ops/csrc/dia_spmv.cu",
        "ginkgo_tpu/ops/spmv_pallas.py:246",
        lambda x: spmv_banded.dia_spmv_complex_cuda(offsets, A.diag_values,
                                                    meta, x),
        lambda x: spmv_banded.dia_spmv_reference(offsets, A.diag_values,
                                                 meta, x),
        A, random_tensor((n, 1), torch.complex64),
        entries * 8 + 2 * n * 8, entries)


def phase_kernel_b_complex(A):
    """Kernel B's complex instantiation over the compact streams of small
    complex slabs in every type pair, then on the complex packed main-path
    matrix."""
    worst = {}
    for data in small_packed_matrices():
        S = gtt.Csr.from_data(data, strategy="packed")
        for vdtype, xdtype in COMPLEX_PAIRS:
            slab = card_slab(S)
            slab[0] = complexify(slab[0], vdtype, seed=S.shape[0])
            sell, smeta = spmv_sell.sell_from_packed(*slab, S.pell_meta)
            if dict(smeta)["entries"] != int((slab[0] != 0).sum()):
                raise AssertionError("the complex stream lost entries")
            for k in (1, 3, 8, 9):
                x = random_tensor((S.shape[1], k), xdtype)
                err = check_complex(
                    lambda x: spmv_packed.pell_spmv_complex_cuda(sell, smeta,
                                                                 x),
                    [lambda x: spmv_sell.sell_spmv_reference(sell, smeta, x),
                     lambda x: spmv_packed.pell_spmv_reference(
                         *slab, S.pell_meta, x)], x)
                key = f"{vdtype}/{xdtype}"
                worst[key] = max(worst.get(key, 0.0), err)
    say("kernel_b_complex_small", max_rel_err=worst)

    n, m = A.shape
    if (A.pell_vals.device.type != "cpu"
            or A.sell["sv"].device.type != DEV.type):
        raise AssertionError("the complex packed slab should stay on the "
                             "host and its stream lie on the card")
    slab = card_slab(A)
    sell, smeta = A.sell, A.sell_meta
    entries = dict(smeta)["entries"]
    x = random_tensor((m, 1), torch.complex64)
    slab_err, _ = rel_err(spmv_packed.pell_spmv_complex_cuda(sell, smeta, x),
                          spmv_packed.pell_spmv_reference(*slab, A.pell_meta,
                                                          x))
    if not slab_err <= TOL[torch.complex64]:
        raise AssertionError(f"pell_spmv_complex disagrees with the slab's "
                             f"plain version: rel err {slab_err:.3e}")
    del slab
    return timed_complex_kernel(
        "kernel_b_complex", "pell_spmv_complex",
        "ginkgo_tpu_torch/ops/csrc/sell_spmv.cu",
        "ginkgo_tpu/ops/spmv_packed.py:411",
        lambda x: spmv_packed.pell_spmv_complex_cuda(sell, smeta, x),
        lambda x: spmv_sell.sell_spmv_reference(sell, smeta, x),
        A, x, entries * (8 + 2) + (m + n) * 8, entries)


def complex_solve(label, A, method, kernel, cap=2000, tol=COMPLEX_TOL,
                  **kw):
    """One complex64 solve on ``A`` to ``COMPLEX_TOL``, b = ones, through
    the port's entry points; the kernel counts are zeroed just before the
    solve and read just after.  Returns the launches."""
    b = torch.ones(A.shape[0], dtype=torch.complex64, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = method.solve(A, b, criteria=Iteration(cap) | ResidualNorm(tol),
                       **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    true_rel = true_rel_residual(A, b, res.x)
    iters = int(res.iterations[0])
    stagnated = None if res.stagnated is None else bool(res.stagnated.any())
    say(label, solver=method.name, n=A.shape[0], tolerance=tol,
        iterations=iters,
        converged=bool(res.converged.all()), stagnated=stagnated,
        solve_s=seconds, ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel,
        launches={k: v for k, v in launches.items() if v},
        peak_memory_GB=peak / 1e9)
    if launches[kernel] <= 0:
        raise AssertionError(f"{label} {method.name}: the solve never "
                             f"launched {kernel}")
    if not bool(res.converged.all()):
        raise AssertionError(f"{label} {method.name}: not converged in "
                             f"{iters} iterations (stagnated {stagnated})")
    limit = max(COMPLEX_TRUE_LIMIT, tol)
    if not (np.isfinite(true_rel) and true_rel <= limit):
        raise AssertionError(f"{label} {method.name}: true relative "
                             f"residual {true_rel:.3e} > {limit}")
    return launches


def main_complex_banded(A):
    """The general complex system on the banded layout: seven solvers
    through kernel A's complex instantiation (Gcr and Gmres also write
    their bases with kernel F)."""
    assert A.strategy == "banded" and A.dtype == torch.complex64
    inner = Gmres.build(criteria=Iteration(15))
    cases = ((Bicgstab, {}), (Bicg, dict(tol=STALL_TOLS["Bicg"])), (Cgs, {}),
             (Gcr, dict(krylov_dim=COMPLEX_KRYLOV_DIM)),
             (Gmres, dict(krylov_dim=COMPLEX_KRYLOV_DIM, ortho="cgs2")),
             (Idr, dict(subspace_dim=2)), (Ir, dict(solver=inner, cap=200)))
    runs = [complex_solve("main_complex_banded", A, solver,
                          "dia_spmv_complex", **kw) for solver, kw in cases]
    for solver, launches in zip((Gcr, Gmres), runs[3:5]):
        if launches["row_write"] <= 0:
            raise AssertionError(f"{solver.name} wrote no basis row with "
                                 f"kernel F")
    return runs


def main_complex_hermitian(H):
    """The Hermitian system on the banded layout: the four Hermitian-only
    Krylov solvers and Chebyshev on its spectrum's enclosure."""
    assert H.strategy == "banded" and H.dtype == torch.complex64
    cases = ((Cg, {}), (Fcg, {}), (PipeCg, dict(tol=STALL_TOLS["PipeCg"])),
             (Minres, {}), (Chebyshev, dict(foci=CHEBYSHEV_FOCI)))
    return [complex_solve("main_complex_hermitian", H, solver,
                          "dia_spmv_complex", **kw) for solver, kw in cases]


def main_complex_packed(A):
    """The general complex system on the packed layout: Jacobi (a complex
    diagonal) with BiCGSTAB, through kernel B's complex instantiation."""
    assert A.strategy == "packed" and A.dtype == torch.complex64
    return complex_solve("main_complex_packed", A, Bicgstab,
                         "pell_spmv_complex", preconditioner=Jacobi())


def phase_entry_points():
    """The main path's own entry points on the card: ``bench_torch``'s
    STREAM and SpMV measurements (its JSON line printed as it prints it)
    and ``graft_entry_torch.entry()``'s CG, held against the same entry on
    the host.  Each is counted as a main path of its own."""
    stream = bench_torch.measure_stream_gbps(DEV)
    reset_counters()
    A, n, gbps = bench_torch.measure_spmv(DEV, BANDED_NX)
    bench_launches = read_counters()
    line = bench_torch.result_line(A, n, gbps, stream, DEV.type)
    del A
    print(json.dumps(line), flush=True)
    fn, args = graft_entry_torch.entry()
    reset_counters()
    x = fn(*args)
    entry_launches = read_counters()
    fn_c, args_c = graft_entry_torch.entry(device="cpu")
    err, _ = rel_err(x.cpu(), fn_c(*args_c))
    say("entry_points", bench=line, bench_launches=bench_launches["dia_spmv"],
        entry_launches=entry_launches["dia_spmv"], entry_x_rel_err=err)
    if bench_launches["dia_spmv"] <= 0 or entry_launches["dia_spmv"] <= 0:
        raise AssertionError("an entry point never launched dia_spmv")
    if not (x.device.type == "cuda" and err <= 1e-5):
        raise AssertionError(f"entry() on the card: x on {x.device}, rel "
                             f"err {err:.3e} to the host's")
    return [bench_launches, entry_launches]


def small_complex_match_cpu():
    """Every Krylov solver on small complex128 systems, banded and packed,
    on the card (the complex kernels A and B, kernel F in 16-byte elements
    for Gcr and Gmres) against the host: equal iterations and converged,
    x to 1e-10."""
    inner = Gmres.build(criteria=Iteration(15))
    general = ((Bicgstab, {}), (Bicg, {}), (Cgs, {}),
               (Gcr, dict(krylov_dim=20)), (Gmres, dict(krylov_dim=20)),
               (Idr, {}), (Ir, dict(solver=inner)))
    herm = ((Cg, {}), (Fcg, {}), (PipeCg, {}), (Minres, {}),
            (Chebyshev, dict(foci=CHEBYSHEV_FOCI)))
    for kind, data in (("banded", stencil_3d(14, points=27)),
                       ("packed", permute_locally(stencil_3d(16, 16, 8,
                                                             points=27)))):
        n = data.shape[0]
        rhs = np.ones((n, 2), np.complex128)
        rhs[:, 1] = np.arange(n) % 7 - 3j
        iters = {}
        for make, cases in ((shifted, general), (hermitian, herm)):
            d = make(data)
            d = gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                               d.values.astype(np.complex128))
            ops = [gtt.Csr.from_data(d, device=dev)
                   for dev in (DEV, torch.device("cpu"))]
            assert ops[0].strategy == ops[1].strategy == kind
            for solver, kw in cases:
                out = []
                for A in ops:
                    reset_counters()
                    res = solver.solve(A, torch.from_numpy(rhs).to(A.device),
                                       criteria=Iteration(1000)
                                       | ResidualNorm(1e-10), **kw)
                    out.append((res.iterations.cpu(), res.converged.cpu(),
                                res.x.cpu(), read_counters()))
                (ig, cg, xg, lg), (ic, cc, xc, _) = out
                kernel = ("dia_spmv_complex" if kind == "banded"
                          else "pell_spmv_complex")
                if lg[kernel] <= 0:
                    raise AssertionError(f"{kind} {solver.name}: the card "
                                         f"never launched {kernel}")
                if solver in (Gcr, Gmres) and lg["row_write"] <= 0:
                    raise AssertionError(f"{solver.name}: no complex128 "
                                         f"row write on kernel F")
                assert bool(cg.all()) and bool(cc.all()), (kind, solver, cg)
                assert torch.equal(ig, ic) and torch.equal(cg, cc), \
                    (kind, solver.name, ig, ic)
                torch.testing.assert_close(xg, xc, rtol=1e-10, atol=1e-10)
                iters[solver.name] = ig.tolist()
        say("small_complex", layout=kind, n=n, iterations=iters)


# -- the format zoo ---------------------------------------------------------------
def card_bytes(op):
    """Bytes of the tensors ``op`` holds on the card (a packed plan's slab,
    kept on the host, is not counted)."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(op)
               if t.device.type == "cuda")


def build_format(name, data, **kw):
    t0 = time.perf_counter()
    op = FORMAT_BUILDS[name](data, dtype=np.float32, **kw)
    torch.cuda.synchronize()
    return op, time.perf_counter() - t0


def check_format(label, name, op, setup_s, strategy, kernel, ref):
    """``op`` (built from the data ``ref``, the ``Csr``, was built from)
    must carry a ``strategy`` plan; its applies at k = 1 and 3 through the
    port's entry point are held against the plain COO product of ``ref``'s
    entries in f64 on the card, and must launch ``kernel`` once each.
    Returns the counted launches and the format's report, with one apply
    timed as kernel A is, beside ``ref``'s apply in the same call."""
    got = None if op.fast_op is None else op.fast_op.strategy
    if got != strategy:
        raise AssertionError(f"{label} {name}: plan {got}, where Csr takes "
                             f"{strategy}")
    n = ref.shape[0]
    vals64 = ref.values.double()
    xs = [torch.randn((n, k), dtype=torch.float32, device=DEV)
          for k in (1, 3)]
    reset_counters()
    ys = [op.apply(x) for x in xs]
    launches = read_counters()
    errs = []
    for x, y in zip(xs, ys):
        want = coo_spmv(ref.row_idx, ref.col_idx, vals64, x.double(), n)
        assert y.shape == want.shape and bool(torch.isfinite(y).all())
        errs.append(rel_err(y, want)[0])
    if launches[kernel] != len(xs):
        raise AssertionError(f"{label} {name}: {launches[kernel]} launches "
                             f"of {kernel} for {len(xs)} applies")
    if not max(errs) <= TOL[torch.float32]:
        raise AssertionError(f"{label} {name}: rel err {max(errs):.3e} "
                             f"against the f64 COO product")
    x = xs[0]
    ms = time_ms(lambda: op.apply(x), 50, queue_ahead=True)
    csr_ms = time_ms(lambda: ref.apply(x), 50, queue_ahead=True)
    return launches, dict(setup_s=setup_s, apply_ms=ms, csr_apply_ms=csr_ms,
                          launches=launches[kernel], max_rel_err=max(errs),
                          card_bytes=card_bytes(op),
                          plan_card_bytes=card_bytes(op.fast_op))


def main_formats_banded(data, A, csr_iters, csr_x, small_data, small_A):
    """Every format of the stencil (``Hybrid``: ``automatic``,
    ``percent=0.8``) through kernel A: ``Ell`` and ``Hybrid`` at nx=160,
    the ``CUT_FORMATS`` at nx=100 (``small_data``, held against
    ``small_A``); then Jacobi-CG with the ``Ell`` operator (its Jacobi
    from ``A``, the phase-6 ``Csr`` of the same data): the same iterations
    and, the same arrays reaching the same kernel, the same x bit for bit.
    Then ``SparsityCsr`` of the nx=100 pattern against value x the
    pattern's row sums.  Returns the counted launches."""
    runs, report = [], {}
    for name in FORMAT_BUILDS:
        src, ref = ((small_data, small_A) if name in CUT_FORMATS
                    else (data, A))
        op, setup_s = build_format(name, src)
        launches, report[name] = check_format(
            "main_formats_banded", name, op, setup_s, "banded", "dia_spmv",
            ref)
        report[name]["nx"] = (SMALL_FORMAT_NX if name in CUT_FORMATS
                              else BANDED_NX)
        runs.append(launches)
        if name == "Ell":
            E = op
        del op
    say("main_formats_banded", n=A.shape[0], nnz=A.nnz, formats=report)

    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=DEV)
    M = Jacobi().generate(A)
    reset_counters()
    t0 = time.perf_counter()
    res = Cg.solve(E, b, criteria=Iteration(2000) | ResidualNorm(SOLVE_TOL),
                   preconditioner=M)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    runs.append(launches)
    iters = int(res.iterations[0])
    true_rel = true_rel_residual(A, b, res.x)
    same_x = bool(torch.equal(res.x, csr_x))
    say("main_ell_cg", iterations=iters, csr_iterations=csr_iters,
        converged=bool(res.converged.all()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, x_equal_to_csr=same_x,
        launches=launches)
    if launches["dia_spmv"] <= 0 or not bool(res.converged.all()):
        raise AssertionError("Ell CG: no kernel A launch, or no convergence")
    if iters != csr_iters or not same_x:
        raise AssertionError(f"Ell CG: {iters} iterations (x equal: "
                             f"{same_x}) where the Csr took {csr_iters}")
    if not (np.isfinite(true_rel) and true_rel <= TRUE_RESIDUAL_LIMIT):
        raise AssertionError(f"Ell CG: true relative residual {true_rel:.3e}")
    del E, M, res

    t0 = time.perf_counter()
    S = gtt.SparsityCsr.from_data(small_data, value=2.0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ones = torch.ones((small_A.shape[0], 1), dtype=torch.float32, device=DEV)
    y = S.apply(ones)
    want = 2.0 * (small_A.row_ptr[1:] - small_A.row_ptr[:-1]).to(
        torch.float32)[:, None]
    if not torch.equal(y, want):
        raise AssertionError("SparsityCsr: apply to ones is not value x the "
                             "pattern's row sums")
    ms = time_ms(lambda: S.apply(ones), 10)
    say("sparsity_csr_banded", nx=SMALL_FORMAT_NX, setup_s=setup_s,
        apply_ms=ms, card_bytes=card_bytes(S), route="coo_spmv")
    return runs


def same_entries(got, want):
    return (tuple(got.shape) == tuple(want.shape)
            and np.array_equal(got.row_idx, want.row_idx)
            and np.array_equal(got.col_idx, want.col_idx)
            and np.array_equal(got.values, want.values))


def phase_mtx_io(d):
    """The ILU system's FEM matrix through Matrix Market text (written
    with ``%.17g``, read back on the native path and through the
    ``filename`` benchmark case) and Ginkgo's binary format in f64/int64
    and f32/int32: each must give back the generated entries exactly.
    Returns the data read through the ``filename`` case."""
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fem.mtx")
        t0 = time.perf_counter()
        gtt.write_mtx(path, d)
        report["write_mtx_s"] = time.perf_counter() - t0
        report["mtx_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back = gtt.read_mtx(path)
        report["read_mtx_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        case = build_matrix_data({"filename": path})
        report["filename_case_s"] = time.perf_counter() - t0
        if not (same_entries(back, d) and same_entries(case, d)):
            raise AssertionError("read_mtx did not give back the written "
                                 "entries")
        for vdtype, idx in ((np.float64, "int64"), (np.float32, "int32")):
            want = d.astype(vdtype)
            bpath = os.path.join(tmp, f"fem_{idx}.bin")
            key = f"{np.dtype(vdtype).name}_{idx}"
            t0 = time.perf_counter()
            gtt.write_binary(bpath, want, index_dtype=idx)
            report[f"write_binary_{key}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = gtt.read_binary(bpath)
            report[f"read_binary_{key}_s"] = time.perf_counter() - t0
            report[f"binary_{key}_bytes"] = os.path.getsize(bpath)
            if not same_entries(got, want) or got.values.dtype != vdtype:
                raise AssertionError(f"read_binary ({key}) did not give "
                                     f"back the written entries")
    say("mtx_io", n=d.shape[0], nnz=d.nnz, native=True, **report)
    return case


def lookup_oracle(d, rows, cols):
    """Host numpy: the index of each (row, col) among the canonical
    entries, -1 where absent."""
    keys = d.row_idx.astype(np.int64) * d.shape[1] + d.col_idx
    q = rows.astype(np.int64) * d.shape[1] + cols
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return np.where(keys[pos] == q, pos, -1)


def main_formats_packed(d, A, bare_iters):
    """Every format of the FEM matrix read back from its file, through
    kernel B (``packed``); BiCGSTAB without a preconditioner on the Hybrid
    (``minimal_storage_limit``) in the bare ``Csr`` solve's iterations;
    ``Csr.permute`` against ``Permutation`` on both sides; ``RowGatherer``
    and ``CsrLookup`` against host numpy; ``Fft3(160)`` against
    ``numpy.fft.fftn`` in f64.  Returns the counted launches."""
    runs, report = [], {}
    for name in FORMAT_BUILDS:
        kw = ({"strategy": HYBRID_SOLVE_STRATEGY} if name == "Hybrid"
              else {})
        op, setup_s = build_format(name, d, **kw)
        launches, report[name] = check_format(
            "main_formats_packed", name, op, setup_s, "packed", "pell_spmv",
            A)
        runs.append(launches)
        if name == "Hybrid":
            H = op
        del op
    say("main_formats_packed", n=A.shape[0], nnz=A.nnz,
        hybrid_strategy=HYBRID_SOLVE_STRATEGY, formats=report)

    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=DEV)
    reset_counters()
    t0 = time.perf_counter()
    res = Bicgstab.solve(H, b, criteria=Iteration(1000)
                         | ResidualNorm(ILU_TOL))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    runs.append(launches)
    iters = int(res.iterations[0])
    true_rel = true_rel_residual(A, b, res.x)
    say("main_hybrid_bicgstab", iterations=iters,
        csr_iterations=bare_iters, converged=bool(res.converged.all()),
        solve_s=seconds, true_rel_residual=true_rel, launches=launches)
    if launches["pell_spmv"] <= 0 or not bool(res.converged.all()):
        raise AssertionError("Hybrid BiCGSTAB: no kernel B launch, or no "
                             "convergence")
    if iters != bare_iters:
        raise AssertionError(f"Hybrid BiCGSTAB: {iters} iterations where "
                             f"the bare Csr solve took {bare_iters}")
    if not (np.isfinite(true_rel) and true_rel <= ILU_TOL):
        raise AssertionError(f"Hybrid BiCGSTAB: true relative residual "
                             f"{true_rel:.3e} > {ILU_TOL}")
    del H, res

    rng = np.random.default_rng(10)
    perm = rng.permutation(n)
    t0 = time.perf_counter()
    B = A.permute(perm)
    torch.cuda.synchronize()
    permute_s = time.perf_counter() - t0
    P = gtt.Permutation.from_indices(perm)
    x = torch.randn((n, 2), dtype=torch.float32, device=DEV)
    perm_err, _ = rel_err(B.apply(x), P.apply(A.apply(P.inverse().apply(x))))
    if not perm_err <= TOL[torch.float32]:
        raise AssertionError(f"Csr.permute disagrees with P A P^T: "
                             f"{perm_err:.3e}")
    if not same_entries(B.to_matrix_data(), permute_data(
            A.to_matrix_data(), perm, gtt.permute_mode.symmetric)):
        raise AssertionError("Csr.permute: entries differ from "
                             "permute_data's")
    rows = rng.integers(0, n, LOOKUP_QUERIES)
    G = gtt.RowGatherer.from_indices(rows, num_cols=n)
    if not np.array_equal(G.apply(x).cpu().numpy(), x.cpu().numpy()[rows]):
        raise AssertionError("RowGatherer disagrees with host numpy")
    t0 = time.perf_counter()
    L = CsrLookup.build(A)
    torch.cuda.synchronize()
    lookup_build_s = time.perf_counter() - t0
    dA = A.to_matrix_data()
    cols = rng.integers(0, n, LOOKUP_QUERIES)
    hit = rng.integers(0, dA.nnz, LOOKUP_QUERIES // 2)
    rows[:hit.size], cols[:hit.size] = dA.row_idx[hit], dA.col_idx[hit]
    got = L.lookup(rows, cols).cpu().numpy()
    want = lookup_oracle(dA, rows, cols)
    if not np.array_equal(got, want):
        raise AssertionError("CsrLookup disagrees with host numpy")
    say("operators_packed", permute_s=permute_s,
        permuted_strategy=B.strategy, permute_rel_err=perm_err,
        row_gather_queries=LOOKUP_QUERIES, lookup_build_s=lookup_build_s,
        lookup_queries=LOOKUP_QUERIES, lookup_hits=int((got >= 0).sum()))
    del B, G, L

    grid = (rng.standard_normal((FFT_EDGE,) * 3)
            + 1j * rng.standard_normal((FFT_EDGE,) * 3)).astype(np.complex64)
    F = gtt.Fft3(FFT_EDGE)
    g = torch.from_numpy(grid.reshape(-1, 1)).to(DEV)
    y = F.apply(g)
    want = np.fft.fftn(grid.astype(np.complex128)).reshape(-1, 1)
    fft_err, _ = rel_err(y, torch.from_numpy(want).to(DEV))
    back_err, _ = rel_err(gtt.Fft3(FFT_EDGE, inverse=True).apply(y), g)
    ms = time_ms(lambda: F.apply(g), 10)
    say("fft3", edge=FFT_EDGE, dtype=str(y.dtype), rel_err=fft_err,
        inverse_rel_err=back_err, ms=ms)
    if not (fft_err <= TOL[torch.complex64]
            and back_err <= TOL[torch.complex64]):
        raise AssertionError(f"Fft3 disagrees with numpy.fft.fftn: "
                             f"{fft_err:.3e} (inverse {back_err:.3e})")
    return runs


SMALL_FORMATS = ("Coo", "Ell", "Sellp", "Hybrid", "Fbcsr", "Dense",
                 "SparsityCsr")


def small_formats_match_cpu():
    """Every format on small f64 and complex128 matrices, banded and
    packed, on the card against the port's CPU run: its apply to 1e-12,
    and ``to_matrix_data`` and the conversions exactly.  The complex ones
    run the complex instantiations of kernels A and B."""
    for kind, data in (("banded", stencil_3d(10, points=27)),
                       ("packed", permute_locally(stencil_3d(
                           16, 16, 8, points=27)))):
        for vdtype in (np.float64, np.complex128):
            d = gtt.MatrixData(data.shape, data.row_idx, data.col_idx,
                               data.values.astype(vdtype)
                               * (1 + 0.3j if vdtype == np.complex128
                                  else 1))
            x = np.random.default_rng(2).standard_normal((d.shape[0], 2))
            x = x.astype(vdtype)
            kernel = {("banded", False): "dia_spmv",
                      ("banded", True): "dia_spmv_complex",
                      ("packed", False): "pell_spmv",
                      ("packed", True): "pell_spmv_complex"}[
                (kind, vdtype == np.complex128)]
            reset_counters()
            for name in SMALL_FORMATS:
                fmt = getattr(gtt, name)
                ops = [fmt.from_data(d, device=dev)
                       for dev in (DEV, torch.device("cpu"))]
                yg, yc = (op.apply(torch.from_numpy(x).to(op.device))
                          for op in ops)
                err, _ = rel_err(yg.cpu(), yc)
                if not err <= 1e-12:
                    raise AssertionError(f"small {kind} {name}: the card "
                                         f"and the host differ by {err:.3e}")
                mg, mc = (op.to_matrix_data() for op in ops)
                if not same_entries(mg, mc):
                    raise AssertionError(f"small {kind} {name}: "
                                         f"to_matrix_data differs")
                if hasattr(ops[0], "to_csr"):
                    cg, cc = (op.to_csr() for op in ops)
                    if not (cg.strategy == cc.strategy and same_entries(
                            cg.to_matrix_data(), cc.to_matrix_data())):
                        raise AssertionError(f"small {kind} {name}: to_csr "
                                             f"differs")
            Ag, Ac = (gtt.Csr.from_data(d, device=dev)
                      for dev in (DEV, torch.device("cpu")))
            for conv in ("to_ell", "to_sellp", "to_hybrid", "to_fbcsr",
                         "to_sparsity_csr"):
                if not same_entries(getattr(Ag, conv)().to_matrix_data(),
                                    getattr(Ac, conv)().to_matrix_data()):
                    raise AssertionError(f"small {kind}: Csr.{conv} differs")
            launches = read_counters()
            if launches[kernel] <= 0:
                raise AssertionError(f"small {kind} {np.dtype(vdtype).name}"
                                     f": the card never launched {kernel}")
            say("small_formats", layout=kind, dtype=np.dtype(vdtype).name,
                formats=list(SMALL_FORMATS), launches={kernel:
                                                       launches[kernel]})


# -- sparse algebra, reorderings, direct solvers, ISAI and SOR ------------------
def stage_split(st, total_s):
    """A generate's seconds by stagetimer stage; host = the rest."""
    transfer = st.stages.get("transfer", 0.0)
    device = st.stages.get("device", 0.0)
    return dict(seconds=total_s, host_s=total_s - transfer - device,
                transfer_s=transfer, device_s=device)


def timed_generate(factory, A):
    """``factory.generate(A)`` under a stagetimer collector: (operator,
    its seconds split by stage)."""
    t0 = time.perf_counter()
    with stagetimer.collect() as st:
        M = factory.generate(A)
        torch.cuda.synchronize()
    return M, stage_split(st, time.perf_counter() - t0)


def seen(launches):
    """The kernels a counted window launched, by count."""
    return {name: count for name, count in launches.items() if count}


def main_isai_spd(A):
    """``Isai(mode="spd")``-CG on the nx=64 27-point stencil (f32) to
    ``DIA_TOL``: IC(0) on the card's host tier, the DIA block fill with an
    (n, 14, 14) batched solve, both inverse factors planned ``banded``, so
    an iteration is three kernel-A launches.  Scalar-Jacobi CG beside it.
    Returns the counted launches."""
    route = isai_mod.isai_route(A, 1, "lower")
    M, setup = timed_generate(Isai(mode="spd"), A)
    layouts = (M.linv.strategy, M.linv_h.strategy)
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    apply_ms = time_ms(lambda: M.apply(b), 50, queue_ahead=True)
    res, seconds, launches, true_rel = counted_solve(A, Cg, M, DIA_TOL)
    iters = int(res.iterations[0])
    say("main_isai_spd", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        fill=route, inverse_layouts=layouts, linv_nnz=M.linv.nnz,
        generate=setup, apply_ms=apply_ms, iterations=iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=seen(launches),
        scalar_jacobi=bare_solve(A, Cg, DIA_TOL, Jacobi().generate(A)))
    if route != "dia" or layouts != ("banded", "banded"):
        raise AssertionError(f"ISAI(spd): fill {route}, inverse layouts "
                             f"{layouts}, not dia and banded")
    check_solve("ISAI(spd) CG", res, launches, true_rel, DIA_TOL,
                ["dia_spmv"])
    if launches["dia_spmv"] < 3 * iters:
        raise AssertionError(f"ISAI(spd) CG: {launches['dia_spmv']} kernel-A"
                             f" launches for {iters} iterations")
    return launches


def main_isai_general(A, bare_iters):
    """``Isai()``-BiCGSTAB on the ILU system to ``ILU_TOL``: the packed
    device fill (an (n, S, S) identity slab, one scatter, the batched
    solve), M planned ``packed``, so kernel B.  A second generate reuses
    the pattern's cached symbolics.  Returns the counted launches."""
    route = isai_mod.isai_route(A)
    isai_mod._ISAI_SYM_CACHE.clear()
    M, setup = timed_generate(Isai(), A)
    _, regenerate = timed_generate(Isai(), A)
    res, seconds, launches, true_rel = counted_solve(A, Bicgstab, M, ILU_TOL,
                                                     cap=1000)
    iters = int(res.iterations[0])
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    say("main_isai_general", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        fill=route, inverse_layout=M.strategy, m_nnz=M.nnz,
        generate=setup, regenerate=regenerate,
        apply_ms=time_ms(lambda: M.apply(b), 50, queue_ahead=True),
        iterations=iters, unpreconditioned_iterations=bare_iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=seen(launches))
    if route != "packed" or M.strategy != "packed":
        raise AssertionError(f"ISAI: fill {route}, layout {M.strategy}, "
                             f"not packed and packed")
    check_solve("ISAI BiCGSTAB", res, launches, true_rel, ILU_TOL,
                ["pell_spmv"])
    return launches


def trisolve_route(op):
    """The algorithm ``auto`` chose for a generated triangular solve, and
    why when it is not the packed exact solve (kernel C)."""
    why = None
    if op.algorithm == "exact":
        why = "a banded factor: the block-inverse solve"
    elif op.algorithm != "exact_packed":
        why = ("the packed exact solve takes f32 factors only"
               if op.inv_diag.dtype != torch.float32 else
               "the packed trisolve plan declined the factor")
    return dict(algorithm=op.algorithm, why=why)


def main_sor(A, bare_iters, ilu_iters):
    """``GaussSeidel()`` and ``Sor(1.2, symmetric=True)`` as BiCGSTAB
    preconditioners on the ILU system to ``ILU_TOL``: the factors have
    ParILU's L and U patterns, so ``auto`` should plan both solves
    ``exact_packed`` (kernel C); whatever it chose is printed with its
    reason.  Returns the counted launches of both solves."""
    runs = []
    for label, factory in (("gauss_seidel", GaussSeidel()),
                           ("ssor", Sor(relaxation_factor=1.2,
                                        symmetric=True))):
        M, setup = timed_generate(factory, A)
        solves = [M] if label == "gauss_seidel" else [M.lower, M.upper]
        routes = [trisolve_route(op) for op in solves]
        res, seconds, launches, true_rel = counted_solve(
            A, Bicgstab, M, ILU_TOL, cap=1000)
        iters = int(res.iterations[0])
        say(f"main_{label}", n=A.shape[0], trisolves=routes,
            generate=setup, iterations=iters, ilu_iterations=ilu_iters,
            unpreconditioned_iterations=bare_iters,
            converged=bool(res.converged.all()),
            stagnated=bool(res.stagnated.any()), solve_s=seconds,
            ms_per_iteration=seconds * 1e3 / max(iters, 1),
            true_rel_residual=true_rel, launches=seen(launches))
        kernels = ["pell_spmv"] + ["tri_packed"] * any(
            r["algorithm"] == "exact_packed" for r in routes)
        check_solve(label, res, launches, true_rel, ILU_TOL, kernels)
        runs.append(launches)
        del M
    return runs


class Timed:
    """A factory whose ``generate`` is timed (ends in a sync); keeps the
    last result."""

    def __init__(self, factory):
        self.factory = factory
        self.seconds = self.result = None

    def generate(self, A):
        t0 = time.perf_counter()
        self.result = self.factory.generate(A)
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        return self.result


def main_direct(d):
    """``ScaledReordered(Direct(Lu()), NestedDissection())`` and the same
    with ``Cholesky()`` on the 2-D 5-point stencil (f64, b = ones): the
    host factorization's seconds and fill, the trisolve algorithm the
    factors get, ms per solve and the true residual.  Returns the counted
    launches of the solves."""
    A = gtt.Csr.from_data(d, dtype=np.float64)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=DEV)
    runs = []
    for label, fact in (("lu", Lu()), ("cholesky", Cholesky())):
        order, factor = Timed(NestedDissection()), Timed(fact)
        t0 = time.perf_counter()
        op = ScaledReordered(inner_operator=Direct(factorization=factor),
                             reordering=order).generate(A)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        F = factor.result
        reset_counters()
        t0 = time.perf_counter()
        x = op.apply(b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counters()
        true_rel = true_rel_residual(A, b, x)
        t0 = time.perf_counter()
        for _ in range(DIRECT_SOLVES):
            op.apply(b)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3 / DIRECT_SOLVES
        say(f"main_direct_{label}", n=A.shape[0], nnz=A.nnz,
            ordering_s=order.seconds, factorization_s=factor.seconds,
            generate_s=generate_s, l_nnz=F.l_factor.nnz,
            u_nnz=F.u_factor.nnz,
            trisolves=[trisolve_route(s) for s in (op.inner.l_solver,
                                                   op.inner.u_solver)],
            levels=[s.num_levels for s in (op.inner.l_solver,
                                           op.inner.u_solver)],
            first_solve_s=first_s, ms_per_solve=solve_ms,
            true_rel_residual=true_rel, launches=seen(launches))
        if not (np.isfinite(true_rel) and true_rel <= DIRECT_TOL):
            raise AssertionError(f"Direct({label}): true relative residual "
                                 f"{true_rel:.3e} > {DIRECT_TOL}")
        runs.append(launches)
        del op, F
    return runs


def phase_spgemm():
    """``Csr.spgemm`` of the 7- and 27-point stencils at nx=64 (f32) with
    themselves: ``auto`` takes the device numeric for the first (12.5M
    contribution pairs) and the host streaming merge for the second; each
    product against the native host product of the same entries."""
    for points in (7, 27):
        d = stencil_3d(SPGEMM_NX, points=points)
        A = gtt.Csr.from_data(d, dtype=np.float32)
        ad = A.to_matrix_data()
        route = spgemm.spgemm_route(ad, ad, A.device)
        t0 = time.perf_counter()
        C = A.spgemm(A, strategy="classical")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = spgemm.spgemm_data(ad, ad, numeric="host")
        host_s = time.perf_counter() - t0
        got = C.to_matrix_data()
        same = (np.array_equal(got.row_idx, want.row_idx)
                and np.array_equal(got.col_idx, want.col_idx))
        err = (float(np.abs(got.values.astype(np.float64) - want.values)
                     .max() / np.abs(want.values).max()) if same
               else float("inf"))
        say(f"spgemm_{points}pt", n=A.shape[0], nnz=A.nnz,
            flops=spgemm.spgemm_flops(ad, ad), route=route,
            seconds=seconds, host_native_s=host_s, c_nnz=C.nnz,
            device=str(C.device), same_pattern=same, max_rel_err=err)
        if route != ("device" if points == 7 else "host"):
            raise AssertionError(f"spgemm {points}pt: route {route}")
        if not (same and err <= SPGEMM_TOL):
            raise AssertionError(f"spgemm {points}pt: pattern equal {same},"
                                 f" rel err {err:.3e}")
        del C, A, got, want


def phase_rcm_case(A_plain):
    """``build_matrix_data`` of the ILU case with ``rcm``: the layout the
    planner chose and one SpMV's time beside the unreordered matrix's,
    the apply held against the f64 COO product."""
    t0 = time.perf_counter()
    d = build_matrix_data({**ILU_CASE, "rcm": True})
    case_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = gtt.Csr.from_data(d, dtype=np.float32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = torch.randn((A.shape[0], 1), dtype=torch.float32, device=DEV)
    reset_counters()
    y = A.apply(x)
    launches = read_counters()
    err = rel_err(y, coo_spmv(A.row_idx, A.col_idx, A.values.double(),
                              x.double(), A.shape[0]))[0]
    say("rcm_case", case_s=case_s, setup_s=setup_s, n=A.shape[0],
        nnz=A.nnz, strategy=A.strategy, unreordered_strategy=A_plain.strategy,
        spmv_ms=time_ms(lambda: A.apply(x), 50, queue_ahead=True),
        unreordered_spmv_ms=time_ms(lambda: A_plain.apply(x), 50,
                                    queue_ahead=True),
        max_rel_err=err, launches=seen(launches))
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"rcm case: SpMV rel err {err:.3e}")


def phase_diagonal(A, A_small, d_small):
    """The five methods ``Diagonal`` gained, on the banded system's
    diagonal taken through ``Coo.extract_diagonal`` on the card, against
    their plain torch formulas; ``Diagonal.from_data`` must give the
    values ``extract_diagonal`` gives (on the nx=100 system: canonicalising
    the nx=160 data again would take seconds of host work)."""
    D = A.to_coo().extract_diagonal()
    v = D.values
    b = torch.randn((3, v.shape[0]), dtype=torch.float32, device=DEV)
    checks = {
        "rapply": torch.equal(D.rapply(b), b * v[None, :]),
        "compute_absolute": torch.equal(D.compute_absolute().values,
                                        torch.abs(v)),
        "conj_transpose": torch.equal(D.conj_transpose().values, v.conj()),
        "transpose": D.transpose() is D,
        "from_data": torch.equal(
            gtt.Diagonal.from_data(d_small, dtype=np.float32).values,
            A_small.to_coo().extract_diagonal().values),
    }
    say("diagonal", n=v.shape[0], device=str(v.device), checks=checks)
    if v.device.type != DEV.type or not all(checks.values()):
        raise AssertionError(f"Diagonal on the card: {checks}")


def small_algebra_match_cpu():
    """f64 on the card against the port's CPU run: ISAI in its four modes
    (the DIA fill on the stencil, the host fill on the FEM matrix), SSOR
    and Gauss-Seidel applies, and ``spgemm_data``'s device numeric on
    both; ``Direct`` and MC64-``ScaledReordered`` solves on the stencil
    (the unordered FEM matrix's LU fills in to seconds a factorization);
    each to 1e-10."""
    cpu = torch.device("cpu")
    for label, d in (("stencil", stencil_3d(8, points=27)),
                     ("fem", build_matrix_data({"fem": 2048,
                                                "offscale": 1.2}))):
        Ag, Ac = (gtt.Csr.from_data(d, device=dev) for dev in (DEV, cpu))
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (d.shape[0], 2)))
        factories = {**{f"isai_{m}": Isai(mode=m) for m in
                        ("general", "lower", "upper", "spd")},
                     "ssor": Sor(symmetric=True), "gs": GaussSeidel()}
        if label == "stencil":
            factories.update(direct=Direct(), mc64_direct=ScaledReordered(
                inner_operator=Direct(), reordering=Mc64()))
        errs = {}
        for name, factory in factories.items():
            yg, yc = (factory.generate(A).apply(x.to(A.device))
                      for A in (Ag, Ac))
            errs[name] = rel_err(yg.cpu(), yc)[0]
        got = spgemm.spgemm_data(d, d, numeric="device", device=DEV)
        want = spgemm.spgemm_data(d, d, numeric="device", device=cpu)
        errs["spgemm_device"] = (
            float(np.abs(got.values - want.values).max()
                  / np.abs(want.values).max())
            if np.array_equal(got.row_idx, want.row_idx)
            and np.array_equal(got.col_idx, want.col_idx) else float("inf"))
        say("small_algebra", matrix=label, rel_err=errs)
        bad = {k: v for k, v in errs.items() if not v <= 1e-10}
        if bad:
            raise AssertionError(f"small {label}: the card and the host "
                                 f"differ: {bad}")


# -- multigrid and the precision tiers ------------------------------------------
def profile_ms(fn, per=1):
    """One call of ``fn`` under ``torch.profiler`` after a warm-up call:
    host ms and device busy ms (the kernels' own time) for each of the
    ``per`` steps the call makes, and its kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    return dict(host_ms=host_s * 1e3 / per,
                device_busy_ms=busy_us / 1e3 / per,
                busy_share=busy_us / 1e6 / host_s,
                kernels=sum(r[2] for r in rows) / per,
                top_us=[[key[:48], us / per, count / per]
                        for us, key, count in rows[:6]])


def mg_levels(mg):
    """Each level's rows, entries, layout, value type, aggregation route
    and transfer layout (``packed``: kernel B; ``gather``: a gather and
    an ``index_add_``), then the coarsest level's rows."""
    rows = []
    for lvl in mg.levels:
        P = getattr(lvl.prolong, "inner", lvl.prolong)
        op = lvl.fine_op
        rows.append(dict(n=op.shape[0], nnz=op.nnz, strategy=op.strategy,
                         dtype=str(op.dtype).replace("torch.", ""),
                         route=lvl.route,
                         transfer="gather" if P.op is None
                         else P.op.strategy))
    rows.append(dict(n=mg.coarsest.shape[0], coarsest="dense inverse"))
    return rows


def counted(fn):
    """``fn()`` with the kernel counts zeroed just before and read just
    after: (its result, seconds, launches)."""
    reset_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counters()


def mg_solve_fields(A, res, seconds, launches, b):
    iters = int(res.iterations[0])
    return dict(iterations=iters, converged=bool(res.converged.all()),
                stagnated=None if res.stagnated is None
                else bool(res.stagnated.any()),
                solve_s=seconds, ms_per_iteration=seconds * 1e3 / max(iters,
                                                                    1),
                true_rel_residual=true_rel_residual(A, b, res.x),
                launches=seen(launches))


def main_mg_dia(A):
    """AMG on the DIA system (``stencil_3d(64, points=27)``, f32): the
    generate (``Pgm``'s ``auto`` must take the ``dia`` matcher on the
    fine level) with its stagetimer split, each level, one V-cycle's
    launches and host/busy split, MG-CG to ``DIA_TOL`` in fewer
    iterations than scalar-Jacobi CG, then the standalone ``Multigrid``
    solve and the W-cycle as the preconditioner.  Returns (the counted
    launches of the three solves, MG-CG's iterations)."""
    mg, setup = timed_generate(Multigrid.build(), A)
    levels = mg_levels(mg)
    C = mg.cycle_operator()
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    _, _, cycle_launches = counted(lambda: C.apply(b))
    cycle = profile_ms(lambda: C.apply(b))
    res, seconds, launches, true_rel = counted_solve(A, Cg, C, DIA_TOL)
    iters = int(res.iterations[0])
    iteration = profile_ms(lambda: Cg.solve(A, b, criteria=Iteration(5),
                                            preconditioner=C), per=5)
    jacobi = bare_solve(A, Cg, DIA_TOL, Jacobi().generate(A))
    crit = Iteration(500) | ResidualNorm(DIA_TOL)
    alone, alone_s, alone_launches = counted(lambda: mg.solve(b,
                                                              criteria=crit))
    Cw = MultigridOp(mg.levels, mg.smoothers, mg.coarsest,
                     cycle="w").cycle_operator()
    wres, w_s, w_launches = counted(lambda: Cg.solve(
        A, b, criteria=Iteration(2000) | ResidualNorm(DIA_TOL),
        preconditioner=Cw))
    say("main_mg_dia", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        generate=setup, levels=levels, v_cycle_launches=seen(cycle_launches),
        v_cycle=cycle, iterations=iters,
        scalar_jacobi_iterations=jacobi["iterations"],
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        launches_per_iteration={k: v / iters for k, v in
                                seen(launches).items()},
        iteration_profile=iteration, true_rel_residual=true_rel,
        launches=seen(launches),
        standalone=mg_solve_fields(A, alone, alone_s, alone_launches, b),
        w_cycle_cg=mg_solve_fields(A, wres, w_s, w_launches, b))
    if mg.levels[0].route != "dia":
        raise AssertionError(f"MG on the DIA system: the fine level took "
                             f"the {mg.levels[0].route} matcher, not dia")
    kernels = ["dia_spmv"] + ["pell_spmv"] * any(
        lvl["strategy"] == "packed" or lvl["transfer"] == "packed"
        for lvl in levels[:-1])
    check_solve("MG-CG (dia)", res, launches, true_rel, DIA_TOL, kernels)
    if not iters < jacobi["iterations"]:
        raise AssertionError(f"MG-CG: {iters} iterations, scalar Jacobi "
                             f"{jacobi['iterations']}")
    for label, r, extra in (("standalone MG", alone, alone_launches),
                            ("W-cycle CG", wres, w_launches)):
        check_solve(label, r, extra, true_rel_residual(A, b, r.x), DIA_TOL,
                    ["dia_spmv"])
    return [launches, alone_launches, w_launches], iters


def main_mg_packed(A, bare_iters, ilu_iters):
    """AMG on the ILU system's FEM matrix (``packed``): ``plan_offsets``
    declines it, so ``auto`` takes the ``packed`` matcher; its stagetimer
    split, the coarse size and the largest aggregate, the levels; then
    BiCGSTAB preconditioned by one V-cycle to ``ILU_TOL`` in fewer
    iterations than the bare solve.  Returns the counted launches."""
    mg, setup = timed_generate(Multigrid.build(), A)
    lvl = mg.levels[0]
    sizes = torch.bincount(lvl.prolong.agg)
    C = mg.cycle_operator()
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    _, _, cycle_launches = counted(lambda: C.apply(b))
    res, seconds, launches, true_rel = counted_solve(A, Bicgstab, C, ILU_TOL,
                                                     cap=1000)
    iters = int(res.iterations[0])
    say("main_mg_packed", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        generate=setup, route=lvl.route, num_coarse=lvl.coarse_op.shape[0],
        largest_aggregate=int(sizes.max()), levels=mg_levels(mg),
        v_cycle_launches=seen(cycle_launches),
        v_cycle=profile_ms(lambda: C.apply(b)), iterations=iters,
        unpreconditioned_iterations=bare_iters, ilu_iterations=ilu_iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=seen(launches))
    if lvl.route != "packed" or A.strategy != "packed":
        raise AssertionError(f"MG on the FEM matrix: route {lvl.route}, "
                             f"layout {A.strategy}, not packed")
    if int(sizes.max()) > 8:
        raise AssertionError(f"MG: an aggregate of {int(sizes.max())} rows")
    check_solve("MG-BiCGSTAB (packed)", res, launches, true_rel, ILU_TOL,
                ["pell_spmv"])
    if not iters < bare_iters:
        raise AssertionError(f"MG-BiCGSTAB: {iters} iterations, {bare_iters}"
                             f" without a preconditioner")
    return launches


def main_mg_mixed(data, f32_iters):
    """The mixed multigrid (``tests/test_twolevel_mixed.py:57,75``): the
    DIA system in f64 (kernel A's f64 instance on the fine level) with
    ``coarse_dtype=torch.float32``; the coarse levels stored in f32 and
    the casts at the transfer operators; CG to ``MIXED_TOL`` with the f64
    true residual under it, and to ``DIA_TOL`` beside the f32 hierarchy's
    iterations.  Returns the counted launches."""
    A = gtt.Csr.from_data(data, dtype=np.float64)
    mg, setup = timed_generate(Multigrid.build(coarse_dtype=torch.float32),
                               A)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=DEV)
    C = mg.cycle_operator()

    def solve(tol):
        return Cg.solve(A, b, criteria=Iteration(2000) | ResidualNorm(tol),
                        preconditioner=C)

    res, seconds, launches = counted(lambda: solve(MIXED_TOL))
    fields = mg_solve_fields(A, res, seconds, launches, b)
    loose = solve(DIA_TOL)
    first = mg.levels[0]
    casts = (first.prolong.out_dtype, first.restrict.out_dtype)
    say("main_mg_mixed", n=A.shape[0], strategy=A.strategy,
        dtype=str(A.dtype), generate=setup, levels=mg_levels(mg),
        casts=[str(t) for t in casts], **fields,
        iterations_to_dia_tol=int(loose.iterations[0]),
        f32_hierarchy_iterations=f32_iters)
    coarse = {lvl.coarse_op.dtype for lvl in mg.levels}
    if (A.strategy != "banded" or first.fine_op.dtype != torch.float64
            or coarse != {torch.float32}
            or casts != (torch.float64, torch.float32)):
        raise AssertionError(f"mixed MG: layout {A.strategy}, coarse "
                             f"{coarse}, casts {casts}")
    check_solve("mixed MG-CG", res, launches, fields["true_rel_residual"],
                MIXED_TOL, ["dia_spmv"])
    return launches


def main_ir_df64(A):
    """``ir_df64`` on the DIA system (f32, b = ones, ``IR_DF64_SWEEPS``
    sweeps) with ``test_df64.py``'s inner solve, CG to ``[Iteration(200),
    ResidualNorm(1e-6)]``: the f64 true residual of the df64 iterate
    under ``IR_DF64_LIMIT``.  Returns the counted launches."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    inner_iters = []

    def inner(A, r):
        res = Cg.solve(A, r, criteria=[Iteration(200), ResidualNorm(1e-6)])
        inner_iters.append(int(res.iterations[0]))
        return res.x.reshape(-1)

    ((xh, xl), hist), seconds, launches = counted(
        lambda: ir_df64(A, b, inner, iterations=IR_DF64_SWEEPS))
    sweeps = list(inner_iters)
    true_rel = true_rel_residual(A, b, xh.double() + xl.double())
    single = true_rel_residual(A, b, inner(A, b))
    say("main_ir_df64", n=A.shape[0], strategy=A.strategy,
        sweeps=IR_DF64_SWEEPS, history=hist.tolist(), inner_iterations=sweeps,
        seconds=seconds, true_rel_residual=true_rel,
        single_f32_solve_true_rel_residual=single, launches=seen(launches))
    if not (np.isfinite(true_rel) and true_rel < IR_DF64_LIMIT):
        raise AssertionError(f"ir_df64: true relative residual "
                             f"{true_rel:.3e} >= {IR_DF64_LIMIT}")
    if launches["dia_spmv"] <= 0:
        raise AssertionError("ir_df64: the inner CG never launched kernel A")
    return launches


def main_ir_dc64(data):
    """``ir_dc64`` on the complex banded system A = P (1 + 0.02i) + 0.5i
    I of the DIA stencil (``shifted``), 5 sweeps: the inner solve is
    complex64 BiCGSTAB through the banded ``Csr`` (kernel A-c) to
    ``ResidualNorm(1e-5)``; the complex128 true residual under
    ``IR_DC64_LIMIT``.  Returns the counted launches."""
    from ginkgo_tpu_torch.ops.spmv_banded import unblock_diag_values
    A = gtt.Csr.from_data(shifted(data), dtype=np.complex64)
    assert A.strategy == "banded" and A.tail_rows is None
    dv = unblock_diag_values(A.diag_values, dict(A.band_meta))
    dv_re, dv_im = dv.real.contiguous(), dv.imag.contiguous()
    n = A.shape[0]
    b = dc_from_c64(np.ones(n, np.complex128), device=DEV)
    inner_iters = []

    def inner(r_re, r_im):
        res = Bicgstab.solve(A, torch.complex(r_re, r_im),
                             criteria=Iteration(2000) | ResidualNorm(1e-5))
        inner_iters.append(int(res.iterations[0]))
        return res.x.real.contiguous(), res.x.imag.contiguous()

    (x, hist), seconds, launches = counted(lambda: ir_dc64(
        A.diag_offsets, dv_re, dv_im, n, b, inner, iterations=IR_DC64_SWEEPS))
    x128 = torch.from_numpy(dc_to_c128(x)).to(DEV)
    true_rel = true_rel_residual(
        A, torch.ones(n, dtype=torch.complex128, device=DEV), x128)
    say("main_ir_dc64", n=n, strategy=A.strategy, dtype=str(A.dtype),
        sweeps=IR_DC64_SWEEPS, history=hist.tolist(),
        inner_iterations=inner_iters, seconds=seconds,
        true_rel_residual=true_rel, launches=seen(launches))
    if not (np.isfinite(true_rel) and true_rel < IR_DC64_LIMIT):
        raise AssertionError(f"ir_dc64: true relative residual "
                             f"{true_rel:.3e} >= {IR_DC64_LIMIT}")
    if launches["dia_spmv_complex"] <= 0:
        raise AssertionError("ir_dc64: the inner BiCGSTAB never launched "
                             "kernel A-c")
    return launches


def small_mg_match_cpu():
    """f64 on the card against the port's CPU run: the ``dia`` and
    ``packed`` matchers' roots index for index on ``stencil_3d(8,
    points=27)`` and the FEM matrix at n = 2,048 (``dia`` declines the
    FEM matrix on both); MG-CG with the four cycles on ``stencil_3d(12,
    points=27)``: equal iterations, x to 1e-10."""
    cpu = torch.device("cpu")
    for label, data in (("stencil", stencil_3d(8, points=27)),
                        ("fem", build_matrix_data({"fem": 2048,
                                                   "offscale": 1.2}))):
        d = data.canonical()
        roots = {}
        for name, fn in (("dia", pgm_dia.aggregate_dia),
                         ("packed", pgm_packed.aggregate_packed)):
            want, got = fn(d, device=cpu), fn(d, device=DEV)
            if (want is None) != (got is None) or (
                    want is not None and not np.array_equal(got, want)):
                raise AssertionError(f"small {label}: the card's {name} "
                                     f"root differs from the CPU's")
            roots[name] = ("declined" if want is None
                           else int(np.unique(want).size))
        say("small_mg_match", matrix=label, n=d.shape[0], roots=roots)
    data = stencil_3d(12, points=27)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(1728))
    for cycle in ("v", "w", "f", "k"):
        out = []
        for dev in (DEV, cpu):
            A = gtt.Csr.from_data(data, dtype=np.float64, device=dev)
            mg = Multigrid.build(cycle=cycle).generate(A)
            res = Cg.solve(A, b.to(dev), criteria=Iteration(500)
                           | ResidualNorm(1e-10),
                           preconditioner=mg.cycle_operator())
            out.append((int(res.iterations[0]), bool(res.converged.all()),
                        res.x.cpu()))
        (ig, cg, xg), (ic, cc, xc) = out
        err = rel_err(xg, xc)[0]
        say("small_mg_match", cycle=cycle, iterations=[ig, ic], rel_err=err)
        if not (cg and cc and ig == ic and err <= 1e-10):
            raise AssertionError(f"small MG-CG ({cycle}): card {ig} "
                                 f"iterations, CPU {ic}, x rel err {err:.3e}")


# -- the batch tier, autodiff, config and the utilities ------------------------------
def tridiagonal(n):
    r = np.arange(n)
    rows = np.concatenate([r, r[1:], r[:-1]])
    cols = np.concatenate([r, r[1:] - 1, r[:-1] + 1])
    return gtt.MatrixData((n, n), rows, cols,
                          np.ones(rows.size)).canonical()


def timed_batch_solve(solver, A, b):
    """One warm solve, then ``BATCH_REPS`` timed ones (host clock around
    synchronised solves): (the last result, ms a solve)."""
    res = solver.solve(A, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BATCH_REPS):
        res = solver.solve(A, b)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3 / BATCH_REPS


def batch_true_residual(A, x, b):
    """Each system's ||b - A x|| / ||b|| in f64, by a scatter over the
    BatchCsr's entries (not the batch apply)."""
    k = A.nnz
    rows, cols = A.row_idx[:k].long(), A.col_idx[:k].long()
    x64, b64 = x.double(), b.double()
    y = torch.zeros_like(x64)
    y.index_add_(1, rows, A.values[:, :k].double() * x64[:, cols])
    return (b64 - y).norm(dim=1) / b64.norm(dim=1)


def batch_fields(res, ms, nb, true_rel):
    return dict(ms_per_solve=ms, systems_per_s=nb / (ms * 1e-3),
                iterations_min=int(res.iterations.min()),
                iterations_max=int(res.iterations.max()),
                all_converged=bool(res.converged.all()),
                any_stagnated=bool(res.stagnated.any()),
                max_true_rel_residual=float(true_rel.max()))


def check_batch(label, res, true_rel):
    if not bool(res.converged.all()):
        bad = int((~res.converged).sum())
        raise AssertionError(f"{label}: {bad} systems did not converge")
    worst = float(true_rel.max())
    if not (np.isfinite(worst) and worst <= BATCH_TRUE_LIMIT):
        raise AssertionError(f"{label}: f64 true residual {worst:.3e} > "
                             f"{BATCH_TRUE_LIMIT}")


def main_batch_cg():
    """BatchCg (f32, ``BATCH_CG_TOL``) at each of ``BATCH_CG_SHAPES``:
    ms a solve, systems/s, iterations, every system's f64 true residual,
    and one solve under ``torch.profiler`` (launches, host ms against the
    card's busy ms)."""
    for nb, n in BATCH_CG_SHAPES:
        d = tridiagonal(n)
        s = np.random.default_rng(n).uniform(0.1, 1.0, nb)
        vals = np.where(d.row_idx == d.col_idx, 2.0 + s[:, None],
                        -1.0).astype(np.float32)
        t0 = time.perf_counter()
        A = tbatch.BatchCsr.from_data((d, vals))
        b = torch.from_numpy(np.random.default_rng(n + 1).standard_normal(
            (nb, n)).astype(np.float32)).to(DEV)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        solver = tbatch.BatchCg(max_iterations=500, tolerance=BATCH_CG_TOL)
        res, ms = timed_batch_solve(solver, A, b)
        true_rel = batch_true_residual(A, res.x, b)
        prof = profile_ms(lambda: solver.solve(A, b))
        label = f"main_batch_cg_{nb}x{n}"
        say(label, systems=nb, n=n, nnz=A.nnz, dtype="float32",
            tolerance=BATCH_CG_TOL, setup_s=setup_s,
            **batch_fields(res, ms, nb, true_rel), profile=prof)
        check_batch(label, res, true_rel)


def batch_bicgstab_pattern():
    """``tools/tpu_smoke.py``'s batch pattern, canonical (the batch's
    values are in its entry order)."""
    return make_spd(generate_random_matrix(24, 24, nonzeros_per_row=(2, 5),
                                           seed=1), shift=1.5).canonical()


def main_batch_bicgstab():
    """Block-Jacobi (4) BatchBicgstab (f32, ``BATCH_BICGSTAB_TOL``) on
    ``BATCH_BICGSTAB_SYSTEMS`` seeded scales of the 24-row SPD pattern,
    then the first ``BATCH_FORMAT_SYSTEMS`` through BatchCsr, BatchEll
    and BatchDense, x held against the BatchCsr's."""
    pattern = batch_bicgstab_pattern()
    nb = BATCH_BICGSTAB_SYSTEMS
    scales = np.random.default_rng(24).uniform(0.5, 2.0, nb)
    vals = (scales[:, None] * pattern.values[None, :]).astype(np.float32)
    solver = tbatch.BatchBicgstab(
        max_iterations=200, tolerance=BATCH_BICGSTAB_TOL,
        preconditioner=tbatch.BatchJacobi(max_block_size=4))
    A = tbatch.BatchCsr.from_data((pattern, vals))
    b = torch.ones((nb, 24), dtype=torch.float32, device=DEV)
    res, ms = timed_batch_solve(solver, A, b)
    true_rel = batch_true_residual(A, res.x, b)
    prof = profile_ms(lambda: solver.solve(A, b))
    say("main_batch_bicgstab", systems=nb, n=24, nnz=A.nnz,
        dtype="float32", block_size=4, tolerance=BATCH_BICGSTAB_TOL,
        **batch_fields(res, ms, nb, true_rel), profile=prof)
    check_batch("main_batch_bicgstab", res, true_rel)
    m = BATCH_FORMAT_SYSTEMS
    t0 = time.perf_counter()
    sub = tbatch.BatchCsr.from_data((pattern, vals[:m]))
    items = [gtt.MatrixData(pattern.shape, pattern.row_idx, pattern.col_idx,
                            v) for v in vals[:m]]
    formats = {"BatchCsr": sub,
               "BatchEll": tbatch.BatchEll.from_data(items),
               "BatchDense": tbatch.BatchDense(sub.to_dense_batch())}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = b[:m]
    out = {}
    for name, op in formats.items():
        res, ms = timed_batch_solve(solver, op, b)
        out[name] = (res, batch_fields(res, ms, m,
                                       batch_true_residual(sub, res.x, b)))
    x_ref = out["BatchCsr"][0].x
    errs = {name: rel_err(res.x, x_ref)[0] for name, (res, _) in out.items()}
    say("main_batch_formats", systems=m, setup_s=setup_s,
        x_rel_err_vs_csr=errs,
        **{name: fields for name, (_, fields) in out.items()})
    for name, (res, _) in out.items():
        check_batch(f"batch_{name}", res,
                    batch_true_residual(sub, res.x, b))
        if not errs[name] <= BATCH_FORMAT_TOL:
            raise AssertionError(f"{name}: x differs from BatchCsr's by "
                                 f"{errs[name]:.3e}")


def batch_match():
    """A small f64 batch (16 systems, k = 2) on the card and on the host:
    equal iterations and convergence a lane, x to 1e-12."""
    pattern = make_spd(generate_random_matrix(24, 24, nonzeros_per_row=(2, 5),
                                              seed=0), shift=1.5).canonical()
    rng = np.random.default_rng(2)
    vals = pattern.values[None, :] * rng.uniform(0.5, 2.0, (16, 1))
    b = rng.standard_normal((16, 24, 2))
    for label, make, block in (("cg_block4", tbatch.BatchCg, 4),
                               ("bicgstab_scalar", tbatch.BatchBicgstab, 1)):
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = tbatch.BatchCsr.from_data((pattern, vals), device=dev)
            res = make(max_iterations=300, tolerance=1e-10,
                       preconditioner=tbatch.BatchJacobi(block)).solve(
                A, torch.from_numpy(b).to(dev))
            out.append((res.iterations.cpu(), res.converged.cpu(),
                        res.x.cpu()))
        (ig, cg, xg), (ic, cc, xc) = out
        err = rel_err(xg, xc)[0]
        say("batch_match", case=label, iterations_min=int(ig.min()),
            iterations_max=int(ig.max()),
            equal_iterations=bool(torch.equal(ig, ic)), x_rel_err=err)
        if not (bool(cg.all()) and torch.equal(ig, ic)
                and torch.equal(cg, cc) and err <= 1e-12):
            raise AssertionError(f"batch {label}: the card and the host "
                                 f"differ ({ig.tolist()} / {ic.tolist()}, "
                                 f"x {err:.3e})")


def fd_direction(d, A):
    """A seeded symmetric direction on ``d``'s pattern, positive (so the
    directional derivative does not cancel), in A's banded layout."""
    lo = np.minimum(d.row_idx, d.col_idx)
    hi = np.maximum(d.row_idx, d.col_idx)
    keys, inv = np.unique(lo * d.shape[0] + hi, return_inverse=True)
    e = np.random.default_rng(7).uniform(0.5, 1.5, keys.size)[inv]
    E = gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx, e),
                          dtype=np.float64)
    if E.diag_offsets != A.diag_offsets or E.band_meta != A.band_meta:
        raise AssertionError("the direction's band layout is not A's")
    return E.diag_values


def autodiff_fd_check():
    """<d||x||^2/d diag_values, V> against central differences along V, in
    f64 on ``stencil_3d(FD_NX, points=27)``, b = ones, plain CG."""
    d = stencil_3d(FD_NX, points=27)
    A = gtt.Csr.from_data(d, dtype=np.float64)
    crit = Iteration(5000) | ResidualNorm(1e-12)
    V = fd_direction(d, A)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=DEV)
    Ag = copy.copy(A)
    Ag.diag_values = A.diag_values.detach().clone().requires_grad_(True)
    solve = make_differentiable_solve(cg_mod.solve, criteria=crit)
    (solve(Ag, b) ** 2).sum().backward()
    directional = float((Ag.diag_values.grad * V).sum())

    def loss(t):
        At = copy.copy(A)
        At.diag_values = A.diag_values + t * V
        return float((cg_mod.solve(At, b, criteria=crit).x ** 2).sum())

    fd = (loss(FD_STEP) - loss(-FD_STEP)) / (2 * FD_STEP)
    return dict(n=A.shape[0], step=FD_STEP, directional=directional, fd=fd,
                rel_err=abs(directional - fd) / abs(fd))


def main_autodiff(A):
    """The differentiable Jacobi-CG on the banded main-path system (f32,
    ``SOLVE_TOL``), loss ||x||^2: gradients to b and to A's value tensors
    (the forward and adjoint solves counted), grad_b against an
    independent solve of the adjoint system (A is symmetric) and its
    residual in f64, then the f64 central-difference check."""
    crit = Iteration(2000) | ResidualNorm(SOLVE_TOL)
    solve = make_differentiable_solve(cg_mod.solve, criteria=crit,
                                      preconditioner=Jacobi())
    fields = [k for k in ("diag_values", "tail_vals")
              if getattr(A, k) is not None]
    Ag = copy.copy(A)
    for name in fields:
        setattr(Ag, name, getattr(A, name).detach().requires_grad_(True))
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV,
                   requires_grad=True)
    reset_counters()
    t0 = time.perf_counter()
    x = solve(Ag, b)
    (x ** 2).sum().backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    grad_b = b.grad
    lam = Cg.solve(A, 2 * x.detach(), criteria=crit,
                   preconditioner=Jacobi()).x
    grads = {name: float(getattr(Ag, name).grad.abs().max())
             for name in fields}
    fd = autodiff_fd_check()
    report = dict(
        n=A.shape[0], strategy=A.strategy, fields=fields,
        forward_backward_s=seconds, launches=seen(launches),
        grad_max_abs=dict(grads, b=float(grad_b.abs().max())),
        grad_b_vs_adjoint_solve=rel_err(grad_b, lam)[0],
        adjoint_true_rel_residual=true_rel_residual(A, 2 * x.detach(),
                                                    grad_b),
        conj_transpose_ms=time_ms(lambda: A.conj_transpose(), 5),
        fd_check=fd)
    say("main_autodiff", **report)
    if launches["dia_spmv"] <= 0:
        raise AssertionError("autodiff: the solves never launched dia_spmv")
    if not all(np.isfinite(v) and v > 0 for v in grads.values()):
        raise AssertionError(f"autodiff: gradients {grads}")
    if not report["grad_b_vs_adjoint_solve"] <= 1e-6:
        raise AssertionError("autodiff: grad_b differs from the adjoint "
                             "solve")
    if not report["adjoint_true_rel_residual"] <= TRUE_RESIDUAL_LIMIT:
        raise AssertionError("autodiff: grad_b misses the adjoint system")
    if not fd["rel_err"] <= FD_TOL:
        raise AssertionError(f"autodiff: central differences {fd}")
    return launches


def trace_kernel_events(logdir, needle):
    """(events, events whose name holds ``needle``) of the one Chrome trace
    ``trace_to`` wrote into ``logdir``."""
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"trace_to wrote {files}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    hits = [ev for ev in events if ev.get("cat") == "kernel"
            and needle in ev.get("name", "")]
    return len(events), len(hits)


def config_solve(A, banded_iters):
    """``parse_json`` of a Jacobi-CG config generated on the banded
    system: the main path's iterations under a ``Convergence`` logger, a
    ``ProfilerHook`` summary, and a ``trace_to`` trace of a second solve
    naming kernel A as often as its wrapper counted."""
    cfg = json.dumps({
        "type": "solver::Cg",
        "preconditioner": {"type": "preconditioner::Jacobi"},
        "criteria": [{"type": "stop::Iteration", "max_iters": 2000},
                     {"type": "stop::ResidualNorm",
                      "reduction_factor": SOLVE_TOL}]})
    solver = parse_json(cfg).generate(A)
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    with capture(Convergence(), ProfilerHook()) as (conv, hook):
        reset_counters()
        t0 = time.perf_counter()
        solver.apply(b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    iters = conv.num_iterations
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        t0 = time.perf_counter()
        with trace_to(tmp):
            solver.apply(b)
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        traced = read_counters()
        events, kernel_a = trace_kernel_events(tmp, "dia_spmv_kernel")
    say("config_solve", iterations=iters,
        main_path_iterations=banded_iters, converged=conv.has_converged(),
        solve_s=seconds, launches=seen(launches),
        profiler_hook=hook.create_summary(), trace_events=events,
        trace_kernel_a_events=kernel_a, traced_solve_s=traced_s,
        traced_launches=seen(traced))
    if iters != banded_iters or not conv.has_converged():
        raise AssertionError(f"config: {iters} iterations, the main path "
                             f"took {banded_iters}")
    if kernel_a != traced["dia_spmv"] or kernel_a <= 0:
        raise AssertionError(f"config: the trace names kernel A {kernel_a} "
                             f"times, its wrapper counted "
                             f"{traced['dia_spmv']}")
    return [launches, traced]


def utils_card(A):
    """``checkpoint`` round trip of the banded Csr (applied bit for bit),
    the exported Jacobi-CG against the direct solve, ``DeviceTimer`` and
    ``topology()``."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "banded.pt")
        t0 = time.perf_counter()
        checkpoint.save(path, A)
        report["save_s"] = time.perf_counter() - t0
        report["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        B = checkpoint.load(path)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
    same = (B.strategy == A.strategy and B.device == A.device
            and torch.equal(B.apply(b), A.apply(b)))
    del B
    crit = Iteration(2000) | ResidualNorm(SOLVE_TOL)
    t0 = time.perf_counter()
    blob = serialize_solve(cg_mod.solve, A, torch.empty(
        A.shape[0], dtype=torch.float32, device="meta"), criteria=crit,
        preconditioner=Jacobi())
    run = load_solve(blob)
    report["export_s"] = time.perf_counter() - t0
    report["export_bytes"] = len(blob)
    del blob
    x = run(A, b)
    x_direct = Cg.solve(A, b, criteria=crit, preconditioner=Jacobi()).x
    exported_same = torch.equal(x, x_direct)
    timer = DeviceTimer()
    timer.tic()
    for _ in range(10):
        A.apply(b)
    report["device_timer_ms_per_apply"] = timer.toc() * 1e3 / 10
    say("utils_card", checkpoint_apply_equal=same,
        export_x_equal=exported_same, topology=topology(), **report)
    if not (same and exported_same):
        raise AssertionError(f"utils: checkpoint equal {same}, export "
                             f"equal {exported_same}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    reports = _cuda.build()
    for name in _cuda.SIGNATURES:
        _cuda.library(name)
    regs = {name: sorted({line.split("Used ")[1].split(",")[0]
                          for line in rep.splitlines() if "Used " in line})
            for name, rep in reports.items()}
    spills = {name: sum("spill" in ln and " 0 bytes spill" not in ln
                        for ln in rep.splitlines())
              for name, rep in reports.items()}
    say("build", seconds=time.perf_counter() - t0, registers=regs,
        lines_with_spills=spills)
    t0 = time.perf_counter()
    prebuilt = os.path.exists(native._LIBPATH)
    if native.lib() is None:
        raise AssertionError("the port's native C++ library did not build "
                             "(ParILU's pair lists need it at this size)")
    say("build_native", seconds=time.perf_counter() - t0,
        library=native._LIBPATH, found_built=prebuilt)
    say("stream", copy_GBps=stream_gbps())

    t0 = time.perf_counter()
    d_banded = stencil_3d(BANDED_NX, points=27)
    Ab = gtt.Csr.from_data(d_banded, dtype=np.float32)
    torch.cuda.synchronize()
    setup_banded = time.perf_counter() - t0
    say("setup_banded", seconds=setup_banded, strategy=Ab.strategy,
        n=Ab.shape[0], nnz=Ab.nnz, band_meta=dict(Ab.band_meta or ()))
    t0 = time.perf_counter()
    d_packed = permute_locally(stencil_3d(*PACKED_DIMS, points=27))
    Ap = gtt.Csr.from_data(d_packed, dtype=np.float32)
    torch.cuda.synchronize()
    setup_packed = time.perf_counter() - t0
    say("setup_packed", seconds=setup_packed, strategy=Ap.strategy,
        n=Ap.shape[0], nnz=Ap.nnz, pell_meta=dict(Ap.pell_meta or ()),
        tail=Ap.tail_rows is not None)
    assert Ab.strategy == "banded" and Ap.strategy == "packed"

    t0 = time.perf_counter()
    d_ilu = build_matrix_data(ILU_CASE)
    Ai = gtt.Csr.from_data(d_ilu, dtype=np.float32)
    torch.cuda.synchronize()
    say("setup_ilu", case=ILU_CASE, seconds=time.perf_counter() - t0,
        strategy=Ai.strategy, n=Ai.shape[0], nnz=Ai.nnz,
        pell_meta=dict(Ai.pell_meta or ()), tail=Ai.tail_rows is not None)
    t0 = time.perf_counter()
    F = ParIlu(iterations=5).generate(Ai)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    M = Ilu(factorization=F).generate(Ai)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("ilu_generate", seconds=t2 - t0, factorization_s=t1 - t0,
        trisolve_generate_s=t2 - t1, l_nnz=F.l_factor.nnz,
        u_nnz=F.u_factor.nnz, l_algorithm=M.l_solver.algorithm,
        u_algorithm=M.u_solver.algorithm,
        l_meta=dict(M.l_solver.tri_meta or ()),
        u_meta=dict(M.u_solver.tri_meta or ()))
    assert Ai.strategy == "packed"
    assert M.l_solver.algorithm == M.u_solver.algorithm == "exact_packed"

    Ft, Mt, plan, ilut_launches = ilut_generate(Ai)
    regenerate_launches = ilut_regenerate(Ai, Ft)
    onehot_launches = ilut_generate_onehot(Ai, Ft, plan)

    kernels = [phase_kernel_a(Ab), phase_kernel_b(Ap, Ai),
               phase_kernel_c(M.l_solver, F.l_factor),
               *phase_kernels_de(plan), phase_kernel_f(Ab.shape[0])]
    del plan

    ilu_launches, ilu_iters, bare_iters = main_ilu(Ai, M)
    banded_launches, banded_iters, banded_x = main_path("banded", Ab,
                                                        "banded", "dia_spmv")
    runs = [banded_launches,
            main_path("packed", Ap, "packed", "pell_spmv")[0],
            ilu_launches, ilut_launches, regenerate_launches,
            main_ilut(Ai, Mt, ilu_iters, bare_iters), onehot_launches,
            main_gmres(Ab), *(main_gmres(Ab, s) for s in CB_STORAGES)]
    gmres_tf32()

    plans = attic_plans(d_ilu)
    say("attic_plans", **{name: dict(p["stats"], plan_s=p["plan_s"])
                          for name, p in plans.items()})
    attic_launches, xs, ys = main_attic(plans, Ai.shape[1])
    runs.append(attic_launches)
    kernels += phase_kernels_gh(plans, xs, ys, Ai)
    del plans, xs, ys
    small_solves_match_cpu()
    small_ilu_solves_match_cpu()
    small_ilut_match_cpu()
    small_gmres_match_cpu()
    runs.append(main_block_jacobi("main_block_jacobi", Ab, banded_iters))
    runs.append(main_autodiff(Ab))
    runs += config_solve(Ab, banded_iters)
    utils_card(Ab)
    del Ap
    d_small = stencil_3d(SMALL_FORMAT_NX, points=27)
    A_small = gtt.Csr.from_data(d_small, dtype=np.float32)
    runs += main_formats_banded(d_banded, Ab, banded_iters, banded_x,
                                d_small, A_small)
    phase_diagonal(Ab, A_small, d_small)
    del d_small, A_small
    del Ab, banded_x
    d_file = phase_mtx_io(d_ilu)
    runs += main_formats_packed(d_file, Ai, bare_iters)
    del d_file
    small_formats_match_cpu()

    # ISAI and SOR on the ILU system, then its RCM-reordered case
    runs.append(main_isai_general(Ai, bare_iters))
    runs += main_sor(Ai, bare_iters, ilu_iters)
    phase_rcm_case(Ai)
    runs.append(main_mg_packed(Ai, bare_iters, ilu_iters))

    # the DIA ParILUT/ParICT path and the adaptive block Jacobi at n =
    # 262,144 (the DIA loop's universe slab: 161 x n f32 for ParILUT)
    t0 = time.perf_counter()
    d_dia = stencil_3d(DIA_NX, points=27)
    Ad = gtt.Csr.from_data(d_dia, dtype=np.float32)
    torch.cuda.synchronize()
    say("setup_dia", seconds=time.perf_counter() - t0, strategy=Ad.strategy,
        n=Ad.shape[0], nnz=Ad.nnz)
    assert Ad.strategy == "banded"
    runs.append(main_dia("main_ilut_dia", Ad, ParIlut, Ilu, Bicgstab))
    runs.append(main_dia("main_ict_dia", Ad, ParIct, Ic, Cg))
    runs.append(main_block_jacobi("main_block_jacobi_adaptive", Ad,
                                  storage_optimization="auto"))
    runs.append(main_isai_spd(Ad))
    # multigrid and the precision tiers on the DIA system
    mg_runs, mg_iters = main_mg_dia(Ad)
    runs += mg_runs
    runs.append(main_ir_df64(Ad))
    del Ad
    runs.append(main_mg_mixed(d_dia, mg_iters))
    runs.append(main_ir_dc64(d_dia))
    del d_dia
    small_dia_and_block_jacobi_match_cpu()
    small_mg_match_cpu()

    # sparse direct solvers and sparse products
    runs += main_direct(stencil_2d(DIRECT_NX, points=5))
    phase_spgemm()
    small_algebra_match_cpu()

    # the batch tier (plain torch: no kernel of the port on its path)
    main_batch_cg()
    main_batch_bicgstab()
    batch_match()

    # the complex path, complex64 at the full width: A = P (1 + 0.02i) +
    # 0.5i I on both layouts and the Hermitian H on the banded one
    complex_ops = {}
    for label, data in (("banded", shifted(d_banded)),
                        ("hermitian", hermitian(d_banded)),
                        ("packed", shifted(d_packed))):
        t0 = time.perf_counter()
        op = gtt.Csr.from_data(data, dtype=np.complex64)
        torch.cuda.synchronize()
        say(f"setup_complex_{label}", seconds=time.perf_counter() - t0,
            strategy=op.strategy, dtype=str(op.dtype), n=op.shape[0],
            nnz=op.nnz)
        complex_ops[label] = op
        del data
    del d_banded, d_packed
    Ac, Hc, Apc = (complex_ops[key] for key in ("banded", "hermitian",
                                                "packed"))
    del complex_ops
    if not (Ac.strategy == Hc.strategy == "banded"
            and Apc.strategy == "packed"):
        raise AssertionError(f"complex layouts {Ac.strategy}/{Hc.strategy}/"
                             f"{Apc.strategy}, not banded/banded/packed")
    kernels += [phase_kernel_a_complex(Ac), phase_kernel_b_complex(Apc)]
    runs += main_complex_banded(Ac)
    runs += main_complex_hermitian(Hc)
    runs.append(main_complex_packed(Apc))
    del Ac, Hc, Apc
    runs += phase_entry_points()
    small_complex_match_cpu()
    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in runs)

    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
