"""Kernel A's wide instance at the 16-RHS cell's shape, against another
version of the source and over its tuning constants.

    python3 tools/torch_dia_wide_probe.py [--old DIR] [--dtypes f32,f64]
                                          [--variants "R=4,B=4;B=8"] [--k 16]

Runs the package's library as ``wide``, and builds ``ops/csrc/dia_spmv.cu``
once per further variant: a copy of the source with the wide instance's
constants set (R: ``kWideRun``, the rows a thread walks; T:
``kWideThreads``; B: ``kWideMinBlocks`` of the 32-bit index path, the
blocks an SM must hold, which caps the registers; the others as the source
has them), compiled with the package's nvcc flags into a temporary
folder.  ``--old DIR`` names the ``ops/csrc`` directory of another
checkout (for example the parent commit unpacked with ``git archive``),
whose ``dia_spmv.cu`` is built the same way and run as ``old``:
``dia_spmv_launch``, 8 columns a launch (the path that k >= 2 took before
the wide instance).

Then on the 27-point band of a 160^3 grid (n = 4,096,000, random values)
it times, for each value dtype of ``--dtypes`` (f32, bf16 and f16 storage
with f32 vectors, f64 with f64 vectors), ``old`` and each variant with
CUDA events, in turns over a few rounds.  Each time is the median of
chains of launches queued behind a spinning kernel.  Every version's y is
checked bit for bit against the package's one-column kernel run column by
column.  Prints the card, each build's ``ptxas`` registers and spill
bytes of the wide kernels, one JSON line a (dtype, version), then a
summary; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from ginkgo_tpu_torch.ops import _cuda, spmv_banded  # noqa: E402

NX = 160
HBM_BYTES_PER_S = 3.35e12
NNZ = (3 * NX - 2) ** 3          # the 27-point stencil's entries at 160^3
CHAINS, LAUNCHES, ROUNDS = 5, 20, 3
SPIN_CYCLES = 50_000_000
DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.float32),
          "f16": (torch.float16, torch.float32),
          "f64": (torch.float64, torch.float64)}
OLD_RHS = 8                      # columns a launch of the old narrow path


CONSTANTS = {"R": r"constexpr int kWideRun = (\d+);",
             "T": r"constexpr int kWideThreads = (\d+);",
             "B": r"kWideMinBlocks = sizeof\(I\) == 4 \? (\d+)"}


def build(name: str, src: str, tmp: Path) -> subprocess.Popen:
    cu = tmp / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o",
                             str(tmp / f"lib{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def variant_source(spec: str) -> str:
    src = (_cuda.SRC_DIR / "dia_spmv.cu").read_text()
    for item in filter(None, spec.split(",")):
        key, value = item.split("=")
        m = re.search(CONSTANTS[key], src)
        assert m, item
        src = src[:m.start(1)] + str(int(value)) + src[m.end(1):]
    return src


def ptxas_report(text: str, needle: str) -> dict:
    """``ptxas -v``'s registers and spill bytes of each kernel whose
    mangled name holds ``needle``: {template arguments: [registers, spill
    stores, spill loads]}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if needle in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [None, 0, 0])[0] = int(m.group(1))
    return {k.split(needle)[1]: v for k, v in out.items()}


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in ("dia_spmv_launch", "dia_spmv_wide_launch"):
        fn = getattr(lib, entry, None)
        if fn is not None:
            fn.argtypes = _cuda.SIGNATURES["dia_spmv"]["dia_spmv_launch"]
            fn.restype = ctypes.c_int
    return lib


def band(dev, vdtype):
    """The 27-point offsets of a 160^3 grid and random band values in
    ``vdtype``, laid out as kernel A reads them."""
    n = NX ** 3
    offsets = tuple(dz * NX * NX + dy * NX + dx for dz in (-1, 0, 1)
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    g = torch.Generator(device=dev).manual_seed(1)
    dv = torch.randn((len(offsets), n), generator=g, device=dev).to(vdtype)
    meta = spmv_banded.plan_banded_layout(offsets, n)
    return offsets, meta, spmv_banded.block_diag_values(dv, meta)


def launcher(fn, offsets, dvb, x, y, width):
    n, k = x.shape
    offs = torch.tensor(offsets, dtype=torch.int32, device=x.device)
    G, D, S, _ = dvb.shape
    vcode, xcode = _cuda.type_code(dvb.dtype), _cuda.type_code(x.dtype)
    esize = x.element_size()

    def apply():
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, k, width):
            rc = fn(vcode, xcode, dvb.data_ptr(), offs.data_ptr(), D, S, n,
                    x.data_ptr() + esize * c0, k,
                    y.data_ptr() + esize * c0, k, min(width, k - c0),
                    stream)
            if rc:
                raise RuntimeError(f"dia_spmv: CUDA error {rc}")
    return apply


def chain_ms(apply) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(LAUNCHES):
        apply()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def probe_dtype(label, libs, k, dev) -> dict:
    """Times of each library's path for ``k`` columns at ``label``'s
    dtypes; raises when one is not bit for bit the one-column kernel."""
    vdtype, xdtype = DTYPES[label]
    offsets, meta, dvb = band(dev, vdtype)
    n = meta["n"]
    x = torch.randn((n, k), device=dev).to(xdtype)
    want = torch.empty_like(x)
    for c in range(k):
        want[:, c:c + 1] = spmv_banded.dia_spmv_cuda(
            offsets, dvb, meta, x[:, c:c + 1].contiguous())
    versions = {}
    for name, lib in libs.items():
        y = torch.empty_like(x)
        if name == "old":
            apply = launcher(lib.dia_spmv_launch, offsets, dvb, x, y,
                             OLD_RHS)
        else:
            apply = launcher(lib.dia_spmv_wide_launch, offsets, dvb, x, y,
                             spmv_banded.WIDE_RHS)
        apply()
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"{label} {name}: not bit for bit, max abs "
                                 f"diff {float((y - want).abs().max())}")
        versions[name] = apply
    times = {name: [] for name in versions}
    for _ in range(ROUNDS):
        for name, apply in versions.items():
            for _ in range(3):
                apply()
            times[name] += [chain_ms(apply) for _ in range(CHAINS)]
    bound_ms = ((NNZ * dvb.element_size() + 2 * n * k * x.element_size())
                / HBM_BYTES_PER_S * 1e3)
    summary = {}
    for name, ts in times.items():
        ms = statistics.median(ts)
        summary[name] = ms
        print(json.dumps({"dtype": label, "version": name, "k": k, "ms": ms,
                          "min_ms": min(ts), "max_ms": max(ts),
                          "bound_ms": bound_ms,
                          "roofline_pct": 100 * bound_ms / ms}), flush=True)
    del x, want, dvb
    torch.cuda.empty_cache()
    return dict(summary, bound_ms=bound_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--dtypes", default="f32")
    ap.add_argument("--variants", default="",
                    help='further constants, e.g. "R=4,B=4;B=8"')
    ap.add_argument("--k", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dia_wide_probe: needs a CUDA card", file=sys.stderr)
        return 2
    labels = args.dtypes.split(",")
    assert all(label in DTYPES for label in labels), labels
    sources = {"wide_" + spec.replace("=", "").replace(",", "_"):
               variant_source(spec)
               for spec in filter(None, args.variants.split(";"))}
    if args.old is not None:
        sources["old"] = (args.old / "dia_spmv.cu").read_text()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        procs = {name: build(name, src, tmp)
                 for name, src in sources.items()}
        # the package's own build, meanwhile (no report when it is cached)
        report = _cuda.build(("dia_spmv",)).get("dia_spmv", "")
        print(json.dumps({"build": "wide", "wide_kernels": ptxas_report(
            report, "dia_spmv_wide_kernel")}), flush=True)
        libs = {"wide": _cuda.library("dia_spmv")}
        for name, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                print(err + out, file=sys.stderr)
                return 1
            if name != "old":
                print(json.dumps({"build": name, "wide_kernels": ptxas_report(
                    err, "dia_spmv_wide_kernel")}), flush=True)
            libs[name] = load(tmp / f"lib{name}.so")
        summary = {label: probe_dtype(label, libs, args.k, dev)
                   for label in labels}
        print(json.dumps({"summary": summary, "bitwise": True, "n": NX ** 3,
                          "k": args.k}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
