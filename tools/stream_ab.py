#!/usr/bin/env python3
"""A/B of the window's two streaming passes — the cross pass (``sv_cross``,
``serve_solve``'s first launch, ``fold_cols``) and the apply pass
(``serve_apply``, ``serve_solve``'s third launch) — against their previous
designs on one CUDA card.

The previous designs (scalar loads, one element a lane a row, Y re-staged
behind two barriers every 128 columns; the apply pass one thread a
column) are not kept in the package: this script builds them from copies
of their sources taken out of git history, loads them beside the current
kernels and, through both designs' C entries (so that at n = 256 the
kernels are timed and not the wrappers' host work):

* checks both designs against the plain twins at chip_smoke.py's gates
  (PASS_TOL; 10× beyond n = 1024 for ``serve_solve``), the current one's
  repeats bit for bit, and prints the largest difference between the two
  (max-abs over max);
* times previous, current, current, previous with CUDA events at
  n ∈ {256, 1024, 2048} × m = 100,000, fp32 and bf16 windows,
  k ∈ {1, 4, 8, 16};
* checks that ``ngd_apply``, the substitution (``trisolve_launch``), the
  Gram, the Cholesky and ``cholupdate`` are bit-identical to the previous
  build of their (unchanged) sources, by swapping the previous library in
  under the ``ops`` wrappers;
* times the cross pass of a bf16 window at 8 and 16 right-hand sides on
  the tensor cores (``tc::cross_mma_kernel``) against the CUDA-core
  vector kernel that would take those inputs without them (a copy of the
  sources in the git-ignored build/ab/stream_cc/ with that dispatch
  switched off, built beside the package's), in turns, for ``sv_cross``,
  ``fold_cols`` and ``serve_solve`` at n ∈ {256, 1024, 2048}, and prints
  the copy's ptxas lines for those kernels;
* holds the current passes on the CUDA cores to their emulated orders
  (``ref.sv_cross_tiles_ref``, ``ref.serve_apply_warps_ref``) bit for bit,
  and the tensor cores' cross pass (and the CUDA-core copy's) to the
  float64 product within TC_TOL of its largest element: V split into
  three bf16 terms lands ≈ 3e-7 away; a copy that splits it into two
  (build/ab/stream_two_term/) lands ≈ 2–3e-6 away and must be refused by
  that gate, which shows the gate can fail.

    # where git is (the copies land in the git-ignored build/ab/stream_prev/):
    python3 tools/stream_ab.py --extract <commit of the previous designs>
    # on the card (needs nvcc):
    python3 tools/stream_ab.py
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
LIBS = ("serve_solve", "fold", "ngd_apply", "gram", "cholesky", "cholupdate")
FILES = tuple(f"{name}.cu" for name in LIBS) + (
    "common.cuh", "cross.cuh", "apply.cuh", "trisolve.cuh", "hopper.cuh")
PREV = ROOT / "build" / "ab" / "stream_prev"
SIZES = (256, 1024, 2048)
KS = (1, 4, 8, 16)
M, LAM = 100_000, 1e-3
PASS_TOL = 1e-4       # chip_smoke.py's, 10× beyond n = 1024 for serve_solve
TC_TOL = 1e-6         # chip_smoke.py's: a bf16 cross pass from the float64 product
CC = ROOT / "build" / "ab" / "stream_cc"
# the line of csrc/cross.cuh that sends a bf16 window on the vector route
# at 8 or 16 right-hand sides to the tensor cores, and its switched-off form
TENSOR_DISPATCH = "constexpr bool kTensor = VEC && sizeof(TX) == 2;"
NO_TENSOR_DISPATCH = "constexpr bool kTensor = false;"
TWO = ROOT / "build" / "ab" / "stream_two_term"
# the loop of csrc/cross.cuh that splits V into three bf16 terms, and a
# lossy form that keeps two (the third term zero)
THREE_TERMS = ("#pragma unroll\n  for (int i = 0; i < 3; ++i) {\n"
               "    t[i] = pack_bf16(v.x, v.y);")
TWO_TERMS = ("  t[2] = 0u;\n  for (int i = 0; i < 2; ++i) {\n"
             "    t[i] = pack_bf16(v.x, v.y);")


def extract(rev: str) -> None:
    PREV.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        src = subprocess.run(["git", "-C", str(ROOT), "show",
                              f"{rev}:{CSRC}/{name}"], capture_output=True,
                             text=True, check=True).stdout
        if name == "cross.cuh" and "stream.cuh" in src:
            raise SystemExit(f"{rev}:{CSRC}/{name} is not the previous design")
        (PREV / name).write_text(src)
    print(f"wrote {', '.join(FILES)} to {PREV} from {rev}")


def prev_split(rows: int, m: int) -> tuple[int, int]:
    """The previous cross pass's split: 32-row tiles, about 528 blocks,
    chunks of 128 columns."""
    tiles = -(-rows // 32)
    P = max(1, min(-(-528 // tiles), -(-m // 128)))
    chunk = -(-(-(-m // P)) // 128) * 128
    return -(-m // chunk), chunk


def patched_copy(dst: Path, old: str, new: str) -> Path:
    """A copy of the package's sources at ``dst`` with ``old`` in
    cross.cuh, found exactly once, replaced by ``new``."""
    src = ROOT / CSRC
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "cross.cuh").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{src}/cross.cuh: {old!r} not found once")
    (dst / "cross.cuh").write_text(text.replace(old, new))
    return dst


def cross_ptxas(log: str) -> list:
    """The ptxas lines (registers, spill) of a build's bf16 vector-route
    CUDA-core cross kernels at 8 and 16 right-hand sides."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill stores" in line or "registers" in line):
            dem = subprocess.run(["c++filt", name], capture_output=True,
                                 text=True).stdout.strip() or name
            if "cross_partial_kernel<__nv_bfloat16" in dem and (
                    ", 8, true>" in dem or ", 16, true>" in dem):
                out.append(f"{dem.split('(')[0]}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", metavar="REV",
                    help="copy the previous sources out of git and stop")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract)
        return 0

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops, ref
    serve = importlib.import_module("repro_torch.kernels.serve_solve")
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in ("gram", "cholesky", "cholupdate", "ngd_apply")}

    if not torch.cuda.is_available():
        print("stream_ab: no CUDA device", file=sys.stderr)
        return 1
    if not all((PREV / name).exists() for name in FILES):
        print(f"stream_ab: {PREV} incomplete; run --extract REV first",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    prev_sigs = {
        "sv_cross_launch": [P, I, P, P, P, I, I, I, I, I, P],
        "serve_apply_launch": [P, I, P, P, P, I, I, I, F, P],
        "serve_solve_launch": [P, I, P, P, P, P, P, I, I, I, I, I, I, F, P],
        "trisolve_launch": serve._SIGNATURES["trisolve_launch"],
        "fold_cols_launch": [P, P, I, P, P, I, I, I, I, I, P],
        **{fn: sig for mod in mods.values() for fn, sig in mod._SIGNATURES.items()},
    }
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in LIBS:
            so = Path(tmp) / f"lib{name}_prev.so"
            procs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(PREV), "-o",
                 str(so), str(PREV / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        copies = [(patched_copy(CC, TENSOR_DISPATCH, NO_TENSOR_DISPATCH),
                   ("serve_solve", "fold"), "_cc"),
                  (patched_copy(TWO, THREE_TERMS, TWO_TERMS),
                   ("serve_solve",), "_two")]
        for where, names, tag in copies:
            for name in names:
                so = Path(tmp) / f"lib{name}{tag}.so"
                procs[name + tag] = (so, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(where), "-o",
                     str(so), str(where / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        _build.build(LIBS)
        prev, cc, two = {}, {}, {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            lib = ctypes.CDLL(str(so))
            if name.endswith(("_cc", "_two")):
                base, tag = name.rsplit("_", 1)
                sigs = serve._SIGNATURES if base == "serve_solve" else \
                    importlib.import_module("repro_torch.kernels.fold")._SIGNATURES
                for fn, sig in sigs.items():
                    getattr(lib, fn).argtypes = sig
                    getattr(lib, fn).restype = I
                lib.repro_set_device.argtypes = [I]
                lib.repro_set_device.restype = I
                lib.repro_error_string.argtypes = [I]
                lib.repro_error_string.restype = ctypes.c_char_p
                (cc if tag == "cc" else two)[base] = lib
                if tag == "cc":
                    for line in cross_ptxas(log):
                        print(f"CUDA-core copy, ptxas {base}: {line}", flush=True)
                continue
            for fn, sig in prev_sigs.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = sig
                    getattr(lib, fn).restype = I
            lib.repro_error_string.argtypes = [I]
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_set_device.argtypes = [I]
            lib.repro_set_device.restype = I
            prev[name] = lib
        cur = {"serve_solve": serve._lib(),
               "fold": _build.library("fold", importlib.import_module(
                   "repro_torch.kernels.fold")._SIGNATURES)}

        def call(lib, fn, *a):
            err = lib.repro_set_device(0) or getattr(lib, fn)(*a)
            if err:
                raise RuntimeError(f"{fn}: CUDA error {err} "
                                   f"({lib.repro_error_string(err).decode()})")

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def time_ms(fn, iters=20, warmup=3):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters

        def rel(a, b):
            a, b = a.double(), b.double()
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

        def passes(S, L, V, w, rows, designs=("prev", "cur")):
            """name → (one function a design, the plain twin): each design's
            function runs it through its C entry into fresh outputs.
            Designs: "prev" (the previous passes), "cur" (the package's),
            "cc" (the package's with a bf16 cross pass on the CUDA cores)."""
            n, m = S.shape
            k = V.shape[1]
            bf = int(S.dtype == torch.bfloat16)
            vec = int(serve.stream_route(m, S.dtype) == "vector")
            kt = serve.trisolve_columns(n, k)
            splits = {"prev": (prev_split(n, m), prev_split(n + k, m)),
                      "cur": (serve.cross_split(n, m, serve.cross_tile(S.dtype, k)),
                              serve.cross_split(n + k, m,
                                                serve.cross_tile(S.dtype, k)))}
            splits["cc"] = splits["cur"]
            libs = {"prev": prev, "cur": cur, "cc": cc}

            def make(which):
                (Pn, chunk), (Pf, chunk_f) = splits[which]
                tail = () if which == "prev" else (vec,)
                apply_tail = () if which == "prev" else (serve.apply_split(m)[1], vec)
                lib_s, lib_f = libs[which]["serve_solve"], libs[which]["fold"]
                part = torch.empty((Pn, n, k), device="cuda")
                part_f = torch.empty((Pf, n + k, k), device="cuda")
                new = lambda *shape: torch.empty(shape, device="cuda")

                def sv_cross():
                    U = new(n, k)
                    call(lib_s, "sv_cross_launch", S.data_ptr(), bf, V.data_ptr(),
                         part.data_ptr(), U.data_ptr(), n, m, k, Pn, chunk, *tail,
                         stream())
                    return U

                def serve_apply():
                    X = new(m, k)
                    call(lib_s, "serve_apply_launch", S.data_ptr(), bf, w.data_ptr(),
                         V.data_ptr(), X.data_ptr(), n, m, k, LAM, *apply_tail, stream())
                    return X

                def serve_solve():
                    X, ww = new(m, k), new(n, k)
                    call(lib_s, "serve_solve_launch", S.data_ptr(), bf, L.data_ptr(),
                         V.data_ptr(), part.data_ptr(), ww.data_ptr(), X.data_ptr(),
                         n, m, k, Pn, chunk, kt, LAM, *apply_tail, stream())
                    return X

                def fold_cols():
                    out = new(n + k, k)
                    call(lib_f, "fold_cols_launch", S.data_ptr(), rows.data_ptr(), bf,
                         part_f.data_ptr(), out.data_ptr(), n, m, k, Pf, chunk_f,
                         *tail, stream())
                    return out
                return {"sv_cross": sv_cross, "serve_apply": serve_apply,
                        "serve_solve": serve_solve, "fold_cols": fold_cols}

            made = [make(which) for which in designs]
            plain = {
                "sv_cross": lambda: ops.sv_cross(S, V, mode="ref"),
                "serve_apply": lambda: ops.serve_apply(S, w, V, LAM, mode="ref"),
                "serve_solve": lambda: ops.serve_solve(S, L, V, LAM, mode="ref"),
                "fold_cols": lambda: torch.cat(ops.fold_cols(S, rows, mode="ref")),
            }
            return {name: tuple(d[name] for d in made) + (plain[name],)
                    for name in plain}

        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((8192, 8192), device="cuda")
        for _ in range(30):                    # bring the clocks up
            x @ x
        del x
        table = []
        for n in SIZES:
            for dtype in (torch.float32, torch.bfloat16):
                S = (torch.randn((n, M), generator=gen, device="cuda")
                     / M ** 0.5).to(dtype)
                S32 = S.float()
                L = torch.linalg.cholesky(
                    S32 @ S32.T + LAM * torch.eye(n, device="cuda")).contiguous()
                del S32
                for k in KS:
                    V = torch.randn((M, k), generator=gen, device="cuda")
                    w = torch.randn((n, k), generator=gen, device="cuda")
                    rows = (torch.randn((k, M), generator=gen, device="cuda")
                            / M ** 0.5).to(dtype)
                    for name, (fp, fc, fr) in passes(S, L, V, w, rows).items():
                        a, b, again, want = fp(), fc(), fc(), fr()
                        torch.cuda.synchronize()
                        tol = PASS_TOL if name != "serve_solve" or n <= 1024 \
                            else 10 * PASS_TOL
                        if not torch.equal(b, again):
                            raise AssertionError(f"{name} n={n} {dtype} k={k}: "
                                                 "repeat not bit-identical")
                        ea, eb = rel(a, want), rel(b, want)
                        if not (ea < tol and eb < tol):
                            raise AssertionError(f"{name} n={n} {dtype} k={k}: "
                                                 f"{ea:.2e} / {eb:.2e} from plain")
                        t = [time_ms(fp), time_ms(fc), time_ms(fc), time_ms(fp)]
                        row = (name, n, str(dtype)[6:], k, min(t[0], t[3]),
                               min(t[1], t[2]), rel(b, a))
                        table.append(row)
                        print(f"{name} n={n} {row[2]} k={k}: previous "
                              f"{t[0]:.4f}/{t[3]:.4f} ms, current {t[1]:.4f}/"
                              f"{t[2]:.4f} ms; {row[6]:.2e} apart; plain "
                              f"{ea:.1e} / {eb:.1e}", flush=True)
                    del V, w, rows
                del S, L

        # a bf16 window's cross pass at 8 and 16 right-hand sides: the
        # tensor cores against the CUDA-core kernel, in turns, both held to
        # the float64 product (sv_cross, fold_cols) within TC_TOL
        tc_table = []
        for n in SIZES:
            S = (torch.randn((n, M), generator=gen, device="cuda")
                 / M ** 0.5).to(torch.bfloat16)
            S32 = S.float()
            L = torch.linalg.cholesky(
                S32 @ S32.T + LAM * torch.eye(n, device="cuda")).contiguous()
            del S32
            for k in (8, 16):
                V = torch.randn((M, k), generator=gen, device="cuda")
                w = torch.randn((n, k), generator=gen, device="cuda")
                rows = (torch.randn((k, M), generator=gen, device="cuda")
                        / M ** 0.5).to(torch.bfloat16)
                Sd, Rd = S.double(), rows.double()
                exact = {"sv_cross": Sd @ V.double(),
                         "fold_cols": torch.cat([Sd @ Rd.T, Rd @ Rd.T])}
                del Sd, Rd
                # the two-term copy must fall outside the gate
                Pn, chunk = serve.cross_split(n, M, serve.cross_tile(S.dtype, k))
                part = torch.empty((Pn, n, k), device="cuda")
                U2 = torch.empty((n, k), device="cuda")
                call(two["serve_solve"], "sv_cross_launch", S.data_ptr(), 1,
                     V.data_ptr(), part.data_ptr(), U2.data_ptr(), n, M, k, Pn,
                     chunk, 1, stream())
                torch.cuda.synchronize()
                d2 = rel(U2, exact["sv_cross"])
                print(f"sv_cross n={n} bf16 k={k}, V in two bf16 terms: "
                      f"{d2:.2e} from float64 (the gate {TC_TOL:g} must "
                      f"refuse it)", flush=True)
                if not d2 >= TC_TOL:
                    raise AssertionError(f"sv_cross n={n} k={k}: a two-term "
                                         f"split lands {d2:.2e} from float64, "
                                         f"inside the gate {TC_TOL:g}")
                del part, U2
                for name, (ft, fc, fr) in passes(S, L, V, w, rows,
                                                 ("cur", "cc")).items():
                    if name == "serve_apply":
                        continue
                    a, again, b, want = ft(), ft(), fc(), fr()
                    torch.cuda.synchronize()
                    if not torch.equal(a, again):
                        raise AssertionError(f"{name} n={n} bf16 k={k}: "
                                             "repeat not bit-identical")
                    tol = PASS_TOL if name != "serve_solve" or n <= 1024 \
                        else 10 * PASS_TOL
                    ea, eb = rel(a, want), rel(b, want)
                    if not (ea < tol and eb < tol):
                        raise AssertionError(f"{name} n={n} bf16 k={k}: "
                                             f"{ea:.2e} / {eb:.2e} from plain")
                    far = ""
                    if name in exact:
                        da, db = rel(a, exact[name]), rel(b, exact[name])
                        far = f"; from float64 {da:.2e} / {db:.2e}"
                        if not (da < TC_TOL and db < TC_TOL):
                            raise AssertionError(
                                f"{name} n={n} bf16 k={k}: {da:.2e} (tensor "
                                f"cores) / {db:.2e} (CUDA cores) from the "
                                f"float64 product, gate {TC_TOL:g}")
                    t = [time_ms(ft), time_ms(fc), time_ms(fc), time_ms(ft)]
                    tc_table.append((name, n, k, min(t[0], t[3]), min(t[1], t[2])))
                    print(f"{name} n={n} bf16 k={k}: tensor cores "
                          f"{t[0]:.4f}/{t[3]:.4f} ms, CUDA cores {t[1]:.4f}/"
                          f"{t[2]:.4f} ms{far}", flush=True)
                del V, w, rows, exact
            del S, L

        # the unchanged kernels, previous library swapped in under ops
        def with_prev(name, fn):
            saved = _build._loaded.get(name)
            _build._loaded[name] = prev[name]
            try:
                out = fn()
                torch.cuda.synchronize()
                return out
            finally:
                if saved is None:
                    _build._loaded.pop(name, None)
                else:
                    _build._loaded[name] = saved

        S = (torch.randn((1024, M), generator=gen, device="cuda") / M ** 0.5)
        v = torch.randn((M,), generator=gen, device="cuda")
        w1 = torch.randn((1024,), generator=gen, device="cuda")
        W = S @ S.T + LAM * torch.eye(1024, device="cuda")
        Lf = torch.linalg.cholesky(W).contiguous()
        X = torch.randn((1024, 16), generator=gen, device="cuda")
        U8 = torch.randn((1024, 8), generator=gen, device="cuda")
        Sb = S.to(torch.bfloat16)
        vb = v.to(torch.bfloat16)
        same = {   # label: (library, the call through ops)
            "ngd_apply fp32": ("ngd_apply", lambda: ops.ngd_apply(S, w1, v, LAM, mode="kernel")),
            "ngd_apply bf16": ("ngd_apply", lambda: ops.ngd_apply(Sb, w1, vb, LAM, mode="kernel")),
            "trisolve k=1": ("serve_solve",
                             lambda: ops.trisolve(Lf, U8[:, :1].contiguous(), mode="kernel")),
            "trisolve k=8": ("serve_solve", lambda: ops.trisolve(Lf, U8, mode="kernel")),
            "gram fp32": ("gram", lambda: ops.gram(S, mode="kernel")),
            "gram bf16": ("gram", lambda: ops.gram(Sb, mode="kernel")),
            "gram_sv fp32": ("gram", lambda: torch.cat(
                [t.reshape(-1) for t in ops.gram_sv(S, v, mode="kernel")])),
            "cholesky": ("cholesky", lambda: ops.cholesky(W, mode="kernel")),
            "cholupdate k=16": ("cholupdate", lambda: ops.cholupdate(Lf, X, mode="kernel")),
        }
        for label, (lib, fn) in same.items():
            b = fn()
            torch.cuda.synchronize()
            a = with_prev(lib, fn)
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"{label}: not bit-identical to the previous build")
            print(f"{label}: bit-identical to the previous build", flush=True)
        del S, Sb, W, Lf, X

        # the current passes against their emulated orders: the CUDA cores'
        # (fp32 at k = 8, bf16 at k = 4) bit for bit; a bf16 window's cross
        # pass at k = 8 and 16 takes the tensor cores, whose order no
        # emulation reproduces: held to the float64 product within TC_TOL
        for dtype, k in ((torch.float32, 8), (torch.bfloat16, 4),
                         (torch.bfloat16, 8), (torch.bfloat16, 16)):
            n, m = 256, 20_000
            S = (torch.randn((n, m), generator=gen, device="cuda") / m ** 0.5).to(dtype)
            V = torch.randn((m, k), generator=gen, device="cuda")
            w = torch.randn((n, k), generator=gen, device="cuda")
            got = {"sv_cross": ops.sv_cross(S, V, mode="kernel"),
                   "serve_apply": ops.serve_apply(S, w, V, 0.37, mode="kernel")}
            emu = {"sv_cross": ref.sv_cross_tiles_ref(S.cpu(), V.cpu()),
                   "serve_apply": ref.serve_apply_warps_ref(S.cpu(), w.cpu(), V.cpu(), 0.37)}
            for name in got:
                g, e = got[name].cpu(), emu[name]
                differ = int((g != e).sum())
                tc = name == "sv_cross" and serve.cross_tensor_cores(dtype, k, "vector")
                far = rel(g, (S.double() @ V.double()).cpu()) if tc else 0.0
                print(f"{name} ({n}, {m}) {str(dtype)[6:]} k={k} against its emulated "
                      f"order: {differ} of {g.numel()} outputs differ, largest "
                      f"{rel(g, e):.1e} of max"
                      + (f" (tensor cores; {far:.2e} from float64)" if tc else ""),
                      flush=True)
                if differ and not tc:
                    raise AssertionError(f"{name}: not the emulated order")
                if not far < TC_TOL:
                    raise AssertionError(f"{name} k={k}: {far:.2e} from the "
                                         f"float64 product, gate {TC_TOL:g}")

    print("\nsummary (ms, best of two; NVIDIA card above):")
    print("pass         n     dtype  k   previous  current  speed-up")
    for name, n, dt, k, tp, tc, _ in table:
        print(f"{name:12s} {n:5d} {dt:8s} {k:2d}  {tp:8.4f} {tc:8.4f}  {tp / tc:5.2f}")
    print("\nbf16 cross pass (ms, best of two): tensor cores against CUDA cores")
    print("pass         n     k   tensor    CUDA   CUDA/tensor")
    for name, n, k, tt, tcc in tc_table:
        print(f"{name:12s} {n:5d} {k:2d}  {tt:8.4f} {tcc:8.4f}  {tcc / tt:5.2f}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
