#!/usr/bin/env python3
"""Time kernels D and E (``ops/csrc/pair_contract.cu``) against another
version of their source, and the CTA sizes and gather variants of the
pad-free pair stream.

    python3 tools/torch_pair_probe.py [--old DIR] [--rounds 5]
                                      [--skip-variants] [--skip-regenerate]

Plans ``ParIlut(iterations=5)`` on the ILU system's FEM matrix
(``chip_smoke.ILU_CASE``, f32) once, as ``chip_smoke.py`` does, then on
its product and denominator plans:

- ``--old DIR`` names the ``ops/csrc`` directory of another checkout (for
  example the parent commit unpacked with ``git archive``) whose
  ``pair_contract.cu`` reads the padded slabs through the entry point of
  that version (``OLD_ARGTYPES``); it is built with the package's nvcc
  flags and called on the same operands;
- every version is first held against the plain version on the slabs,
  then all are timed in turns, the order reversed every other round, with
  CUDA events queued behind a spinning kernel;
- variants (unless ``--skip-variants``), each built from a copy of the
  package's source patched by ``PATCHES`` and written under
  ``build/pair_probe/``: 4, 8 and 32 warps (consecutive tiles) a CTA
  (16 in the package), the gather of a or b dropped (``no_a_gather``,
  ``no_b_gather``: another function; what staging that window could save
  at most), and each vreg's a window staged in shared memory by
  ``cp.async`` one vreg ahead, double-buffered (``stage_a_*``: the first
  16 KB or 8 KB of the window, the rows past it gathered, 4 or 8 warps a
  CTA for the shared memory); and kernel E over the stream with each
  vreg's pairs sorted by ``pus`` (``pu_sorted``);
- unless ``--skip-regenerate``: the same-pattern regenerate (a second
  ``ParIlut(5).generate`` on the cached plan) with the package's kernel D
  and, given ``--old``, with the old one on the slabs, in turns, each with
  its stagetimer split.

Prints the card's ``nvidia-smi`` name and power limit and one JSON object
a measurement; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from torch_cf_probe import build_other, in_turns, medians  # noqa: E402
import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch.benchmark import build_matrix_data  # noqa: E402
from ginkgo_tpu_torch.factorization import ParIlut  # noqa: E402
from ginkgo_tpu_torch.ops import _cuda, pair_contract  # noqa: E402
from ginkgo_tpu_torch.utils import stagetimer  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the slab kernels' entry point: mode, vcode, a, na, b, nb, pls, pus,
# pes|pos, pesp, lq, uq, nv, lbase, ubase, T, NV, n_out, y, stream
OLD_ARGTYPES = [_I, _I, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                _I, _I, _L, _P, _P]
MODES = {"D": 0, "E": 1}
GATHER_A = "gather(a, na, abase + idx16(c.l, j))"
GATHER_B = "gather(b, nb, bbase + idx16(c.u, j))"


def warps(n):
    return [("constexpr int kWarps = 16;", f"constexpr int kWarps = {n};", 1)]


# The staged a window: helpers before the product, a buffer pair a warp
# after the accumulators, vreg k + 1's window copied while vreg k is
# summed (cp.async groups, one committed a vreg, the previous one waited
# for), pairs whose a offset lies past the staged part gathered as before.
STAGE_HELPERS = """constexpr int kStageBytes = %d;

template <typename T>
__device__ __forceinline__ T read_a(const T* sa, const T* __restrict__ a,
                                    long long na, long long abase, int i) {
  return (unsigned)i < (unsigned)(kStageBytes / sizeof(T))
             ? sa[i] : gather(a, na, abase + i);
}

template <typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* a, long long na,
                                             long long abase, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  for (int i = lane; i < kStageBytes / 16; i += 32) {
    const long long e0 = abase + (long long)i * kPer;
    const long long left = na - e0;
    const int bytes = e0 < 0 || left <= 0 ? 0
                      : left >= kPer      ? 16
                                          : (int)(left * sizeof(T));
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i * kPer));
    asm volatile("cp.async.cg.shared.global [%%0], [%%1], 16, %%2;\\n"
                 ::"r"(d), "l"(bytes ? a + e0 : a), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

// the product rounded on its own"""


def stage_a(nwarps, stage_bytes):
    return warps(nwarps) + [
        (GATHER_A, "read_a(sa, a, na, abase, idx16(c.l, j))", 2),
        ("const Chunk& c, bool live, long long abase,",
         "const Chunk& c, bool live, long long abase, const T* sa,", 2),
        ("c, live, abase, bbase", "c, live, abase, sa, bbase", 2),
        ("// the product rounded on its own", STAGE_HELPERS % stage_bytes, 1),
        ("T* const acc = reinterpret_cast<T*>(smem_raw) + warp * kOW;",
         "T* const acc = reinterpret_cast<T*>(smem_raw) + warp * kOW;\n"
         "  T* const win = reinterpret_cast<T*>(\n"
         "      smem_raw + kWarps * kOW * sizeof(T) + warp * 2 * kStageBytes);"
         "\n  constexpr int kStage = kStageBytes / (int)sizeof(T);", 1),
        ("    int carry_q = -1;\n    while (k < nvt) {\n",
         "    int carry_q = -1;\n"
         "    stage_window(win, a, na, (long long)wa * kLanes, lane);\n"
         "    bool first = true;\n"
         "    while (k < nvt) {\n"
         "      if (first) {\n"
         "        __syncwarp();\n"
         "        if (k + 1 < nvt)\n"
         "          stage_window(win + ((k + 1) & 1) * kStage, a, na,\n"
         "                       (long long)__ldg(va + v0 + k + 1) * kLanes,"
         " lane);\n"
         "        else\n"
         "          asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");\n"
         "        asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
         "        __syncwarp();\n"
         "      }\n"
         "      const T* sa = win + (k & 1) * kStage;\n", 1),
        ("      const bool last = s >= e;\n",
         "      const bool last = s >= e;\n      first = last;\n", 1),
        ("constexpr int kBytes = kWarps * kOW * sizeof(T);",
         "constexpr int kBytes = kWarps * (kOW * sizeof(T) + 2 * kStageBytes);",
         1),
        ("misaligned(cl) ||", "misaligned(a) || misaligned(cl) ||", 1)]


PATCHES = {"warps4": warps(4), "warps8": warps(8), "warps32": warps(32),
           "no_a_gather": [(GATHER_A, "T(idx16(c.l, j))", 2)],
           "no_b_gather": [(GATHER_B, "T(idx16(c.u, j))", 2)],
           "stage_a_w4": stage_a(4, 16384), "stage_a_w8": stage_a(8, 8192)}


def build_patched(label, patches):
    """The library of the package's ``pair_contract.cu`` with each
    (text, replacement, count) of ``patches`` applied."""
    text = (_cuda.SRC_DIR / "pair_contract.cu").read_text()
    for old, new, count in patches:
        if text.count(old) != count:
            raise AssertionError(f"{label}: {old!r} found {text.count(old)} "
                                 f"times, expected {count}")
        text = text.replace(old, new)
    out = REPO / "build" / "pair_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"pair_contract-{label}.cu"
    src.write_text(text)
    return build_other(src, "pair_contract")[0]


def bind(fn):
    fn.argtypes, fn.restype = OLD_ARGTYPES, ctypes.c_int
    return fn


def slab_launch(fn, mode, a, b, slabs, meta, y):
    """A launch of the slab kernels of another version."""
    third = slabs["pes"] if mode == 0 else slabs["pos"]
    fourth = slabs["pesp"].data_ptr() if mode == 0 else None
    _cuda.check("pair_contract", fn(
        mode, _cuda.type_code(a.dtype), a.data_ptr(), a.shape[0],
        b.data_ptr(), b.shape[0], slabs["pls"].data_ptr(),
        slabs["pus"].data_ptr(), third.data_ptr(), fourth,
        slabs["lq"].data_ptr(), slabs["uq"].data_ptr(),
        slabs["nv"].data_ptr(), slabs["lbase"].data_ptr(),
        slabs["ubase"].data_ptr(), meta["T"], meta["NV"], meta["n_out"],
        y.data_ptr(), torch.cuda.current_stream().cuda_stream))


def stream_launch(fn, mode, a, b, st, meta, y):
    """A launch of a build of this version's stream kernels (COO tail
    included)."""
    _cuda.check("pair_contract", fn(
        mode, _cuda.type_code(a.dtype), a.data_ptr(), a.shape[0],
        b.data_ptr(), b.shape[0],
        *(st[k].data_ptr() for k in pair_contract.STREAM), meta["T"],
        meta["n_out"], *(st[k].data_ptr() for k in pair_contract.TAIL),
        st["tpo"].numel(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream))


def pu_sorted(st):
    """The stream with each vreg's pairs sorted by ``cu`` (stable; the
    padding stays last): b's loads of a warp share more sectors, a's
    fewer.  Kernel E takes it; kernel D needs the slot order."""
    size = st["vstart"][1:] - st["vstart"][:-1]
    vreg = torch.repeat_interleave(torch.arange(size.numel(),
                                                device=size.device), size,
                                   output_size=st["cl"].numel())
    pad = (st["co"] >= 1024).long()
    key = (vreg << 17) | (pad << 16) | st["cu"].long()
    order = torch.sort(key, stable=True).indices
    return dict(st, **{k: st[k][order].contiguous()
                       for k in ("cl", "cu", "co")})


def plan_case(cplan, seed):
    """Operands, the slabs, both stream orders and the plain results."""
    a, b, arrs, meta_items, raw, repack_ms = cs.contraction_case(cplan, seed)
    pu = pu_sorted(arrs["stream"])
    plain = {}
    prev = pair_contract._DOT_MODE
    try:
        for name, mode in (("D", "cumsum_batched"), ("E", "onehot")):
            pair_contract._DOT_MODE = mode
            plain[name] = pair_contract.pair_contract_planned_reference(
                a, b, arrs, meta_items)
    finally:
        pair_contract._DOT_MODE = prev
    return a, b, arrs, pu, dict(meta_items), plain, repack_ms


def probe_plan(pname, cplan, seed, old, rounds, builds):
    a, b, arrs, pu, meta, plain, repack_ms = plan_case(cplan, seed)
    st = arrs["stream"]
    new = _cuda.library("pair_contract").pair_contract_launch
    fns = {}
    for name, mode in MODES.items():
        fns[f"{name}"] = (new, mode, st, True)
        if old is not None:
            fns[f"{name}_old"] = (old, mode, None, True)
    if builds:
        fns["E_pu"] = (new, 1, pu, True)
    for label, fn in builds.items():
        exact = not label.startswith("no_")
        for name, mode in MODES.items():
            fns[f"{name}_{label}"] = (fn, mode, st, exact)
    runs, errs = {}, {}
    tail = tuple(arrs["tail"])
    for label, (fn, mode, stream, exact) in fns.items():
        y = torch.empty(meta["n_out"], dtype=a.dtype, device=cs.DEV)
        if stream is None:
            run = (lambda fn=fn, mode=mode, y=y:
                   slab_launch(fn, mode, a, b, arrs, meta, y))
        else:
            run = (lambda fn=fn, mode=mode, stream=stream, y=y:
                   stream_launch(fn, mode, a, b, stream, meta, y))
        run()
        torch.cuda.synchronize()
        if exact:
            got = (pair_contract._add_tail(y.clone(), a, b, tail)
                   if stream is None else y)
            errs[label] = cs.rel_err(got, plain["D" if mode == 0
                                               else "E"])[0]
            tol = cs.PAIR_TOL["pair_contract_cumsum" if mode == 0
                              else "pair_contract_onehot"]
            if errs[label] > tol:
                raise AssertionError(f"{pname} {label}: rel err "
                                     f"{errs[label]:.3e} > {tol}")
        runs[label] = run
    turns = in_turns(runs, rounds,
                     lambda fn: cs.time_ms(fn, 20, queue_ahead=True))
    nbytes, nops = cs.pair_needed_bytes_ops(cplan)
    bms, by = cs.bound(nbytes, nops)
    med = medians(turns)
    cs.say("probe_pair", plan=pname, T=meta["T"], NV=meta["NV"],
           GWL=meta["GWL"], GWU=meta["GWU"],
           live_vregs=int(cplan["kernel"]["nv"].sum()),
           stream_pairs=cs.pairs_in(st), stream_slots=st["cl"].numel(),
           live_vreg_fill=cs.pairs_in(st)
           / (int(cplan["kernel"]["nv"].sum()) * 1024),
           repack_ms=repack_ms, bound_ms=bms, bound_by=by, ms=med,
           vs_bound={k: bms / v for k, v in med.items()}, ms_turns=turns,
           max_rel_err=errs)


@contextlib.contextmanager
def kernels_from(old, slabs_by_meta):
    """Within the block, the package's launches of kernels D and E go to
    ``old``, the slab kernels, on the slabs of the plan they are handed
    (kept by meta)."""
    real = pair_contract._launch

    def launch(kernel, mode, a, b, arrs, meta_items):
        slabs = slabs_by_meta[id(meta_items)]
        meta = dict(meta_items)
        y = torch.empty(meta["n_out"], dtype=a.dtype, device=a.device)
        slab_launch(old, mode, a, b, slabs, meta, y)
        kernel.launches += 1
        return pair_contract._add_tail(y, a, b, slabs["tail"])

    pair_contract._launch = launch
    try:
        yield
    finally:
        pair_contract._launch = real


def probe_regenerate(A, plan, old, rounds):
    """Host, transfer and device seconds of the cached-plan regenerate
    with this version's kernel D and the old one, in turns."""
    slabs = {}
    for pname in ("prod", "den"):
        k = plan[pname]["kernel"]
        slabs[id(k["meta"])] = {n: torch.from_numpy(k[n]).to(cs.DEV)
                                for n in cs.PLAN_STREAMS}
        slabs[id(k["meta"])]["tail"] = tuple(
            torch.from_numpy(t).to(cs.DEV).long() for t in k["tail"])

    def regenerate(use_old):
        cs.reset_counters()
        ctx = kernels_from(old, slabs) if use_old else contextlib.nullcontext()
        with ctx, stagetimer.collect() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            F = ParIlut(iterations=cs.ILUT_ITERATIONS).generate(A)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = cs.read_counters()["pair_contract_cumsum"]
        if F.route != "packed" or launches != 42:
            raise AssertionError(f"regenerate: route {F.route}, {launches} "
                                 f"launches of kernel D")
        transfer = st.stages.get("transfer", 0.0)
        device = st.stages.get("device", 0.0)
        return dict(seconds=seconds, host_s=seconds - transfer - device,
                    transfer_s=transfer, device_s=device)

    fns = {"kernel": False}
    if old is not None:
        fns["old"] = True
    for use_old in fns.values():
        regenerate(use_old)                 # warm-up
    turns = in_turns(fns, rounds, regenerate)
    cs.say("probe_regenerate", rounds=turns,
           median_s={name: medians({k: [r[k] for r in t] for k in t[0]})
                     for name, t in turns.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--skip-variants", action="store_true")
    ap.add_argument("--skip-regenerate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pair_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _cuda.build(("pair_contract",))
    old = None
    if args.old is not None:
        fn, _ = build_other(args.old / "pair_contract.cu", "pair_contract")
        old = bind(fn)
    builds = ({} if args.skip_variants else
              {label: build_patched(label, p) for label, p in PATCHES.items()})
    if cs.native.lib() is None:
        raise AssertionError("the native C++ library did not build")
    A = gtt.Csr.from_data(build_matrix_data(cs.ILU_CASE), dtype=cs.np.float32)
    t0 = time.perf_counter()
    ParIlut(iterations=cs.ILUT_ITERATIONS).generate(A)
    torch.cuda.synchronize()
    cs.say("probe_first_generate", seconds=time.perf_counter() - t0)
    plan = cs.ilut_plan(A)
    for pname, seed in (("prod", 31), ("den", 32)):
        probe_plan(pname, plan[pname], seed, old, args.rounds, builds)
    if not args.skip_regenerate:
        probe_regenerate(A, plan, old, max(3, args.rounds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
