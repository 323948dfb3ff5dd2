#!/usr/bin/env python3
"""Time edited copies of the fp32 CUDA-core kernels against the sources,
in turns, on one GPU.

    PYTHONPATH=src python tools/kernel_variants.py [--out FILE]

Each variant in `VARIANTS` is a copy of `csrc/matmul.cu` or
`csrc/flash_attention.cu` with textual edits, built with the port's nvcc
flags under its own name (the copy is removed once built), loaded through
ctypes and timed with CUDA events beside the unedited source at the shapes
`chip_smoke.py` times: the fp32 matmul at 8192^3 at three tiles, the fp32
flash kernel causal at [1, 4096, 14/2, 64], [4, 2048, 16/16, 128] and
[4, 2048, 16/1, 256].  Two rounds, the second in reverse order.  A variant
that keeps the function is first held to the plain version (the smoke's
bounds); a probe (its name starts with "probe") changes the function and
is timed only.  Prints one JSON line per source and writes them to
`--out`.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: source -> variant -> [(text, replacement)]
VARIANTS = {
    "matmul": {
        # two 256-thread blocks an SM: at most 128 registers a thread
        "cap128": [("__launch_bounds__(CcCfg<BM, BK, BN>::kThreads)",
                    "__launch_bounds__(CcCfg<BM, BK, BN>::kThreads, "
                    "65536 / (128 * CcCfg<BM, BK, BN>::kThreads))")],
        # one y row for the 4 K steps of an x chunk: 10 fragment loads a
        # chunk instead of 16 (a wrong product; timed only)
        "probe_one_y_row_a_chunk": [
            ("const float* yr = ys + (4 * c + kk) * BN;",
             "const float* yr = ys + 4 * c * BN;")],
    },
    "flash_attention": {
        # exp2f with log2(e) folded into q's scale: no longer a power of
        # two at hd 16, 64, 256, so q * scale rounds (beyond FLASH_TOL at
        # hd 256 on the card; timed only)
        "probe_exp2f": [("expf(s[i][j] - m_new)", "exp2f(s[i][j] - m_new)"),
                        ("expf(m[i] - m_new)", "exp2f(m[i] - m_new)"),
                        ("(1.0 / std::sqrt(double(HD)));\n  kernel<<<"
                         "static_cast<unsigned int>(blocks), kThreads, smem, "
                         "stream>>>(\n      static_cast<T*>(out)",
                         "(1.4426950408889634 / std::sqrt(double(HD)));\n"
                         "  kernel<<<static_cast<unsigned int>(blocks), "
                         "kThreads, smem, stream>>>(\n      "
                         "static_cast<T*>(out)")],
        "one_block_an_sm_to_hd64": [("HD <= 64 ? 2 : 1", "1")],
        "three_slots_at_hd64": [("FLASH_TILE(64, 64, 2)",
                                 "FLASH_TILE(64, 64, 3)")],
        "three_slots_at_hd128": [("FLASH_TILE(128, 64, 4)",
                                  "FLASH_TILE(128, 64, 3)")],
    },
}
TILES = ((128, 32, 64), (128, 64, 128), (128, 32, 128))
FLASH_SHAPES = ((1, 4096, 14, 2, 64), (4, 2048, 16, 16, 128),
                (4, 2048, 16, 1, 256))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(build) -> dict:
    """Every variant's library, by (source, variant); "base" is the
    source as it is."""
    names = {}
    try:
        for src, variants in VARIANTS.items():
            names[(src, "base")] = src
            text = (build.CSRC / f"{src}.cu").read_text()
            for var, edits in variants.items():
                edited = text
                for old, new in edits:
                    if text.count(old) != 1:
                        raise ValueError(f"{src} {var}: {old!r} is not in the "
                                         "source exactly once")
                    edited = edited.replace(old, new)
                name = f"{src}__{var}"
                (build.CSRC / f"{name}.cu").write_text(edited)
                names[(src, var)] = name
        build.build(sorted(set(names.values())))
        paths = {k: build.library_path(n) for k, n in names.items()}
    finally:
        for name in names.values():
            if "__" in name:
                (build.CSRC / f"{name}.cu").unlink(missing_ok=True)
    return {k: ctypes.CDLL(str(p)) for k, p in paths.items()}


def _matmul(lib, x, y, tile):
    fn = lib.matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_int64] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = torch.empty((x.shape[0], y.shape[1]), device=x.device)
    err = fn(0, out.data_ptr(), x.data_ptr(), y.data_ptr(), 0, 0,
             x.shape[0], x.shape[1], y.shape[1], y.shape[1], *tile,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"matmul launch: CUDA error {err}")
    return out


def _flash(lib, q, k, v):
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_int64] * 6 + [ctypes.c_int]
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    out = torch.empty_like(q)
    b, sq, h, hd = q.shape
    err = fn(0, out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), 0,
             b, sq, k.shape[1], h, k.shape[2], hd, 1, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash launch: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_plain
    smoke = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = _build(build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []

    keys = [k for k in libs if k[0] == "matmul"]
    x = torch.randn((8192, 8192), generator=gen, device="cuda")
    y = torch.randn((8192, 8192), generator=gen, device="cuda")
    xs, ys = x[:300, :997].contiguous(), y[:997, :259].contiguous()
    ms = {}
    for rnd, order in enumerate((keys, keys[::-1])):
        for key in order:
            for tile in TILES:
                if rnd == 0 and not key[1].startswith("probe"):
                    res = smoke.matmul_against_plain(
                        xs, ys, {"o": _matmul(libs[key], xs, ys, tile)},
                        tile[1])["o"]
                    if res["tol_ratio"] > 1 or not res["finite"]:
                        raise RuntimeError(f"{key} {tile}: {res}")
                ms.setdefault(f"{key[1]} {tile}", []).append(
                    smoke.device_ms(lambda: _matmul(libs[key], x, y, tile),
                                    reps=3, inner=1))
    records.append({"source": "matmul", "shape": [8192, 8192, 8192],
                    "ms": ms, "nvidia_smi": smi})
    del x, y

    keys = [k for k in libs if k[0] == "flash_attention"]
    ms = {}
    for shape in FLASH_SHAPES:
        b, s, h, kv, hd = shape
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
        atol, rtol = smoke.FLASH_TOL[torch.float32]
        for rnd, order in enumerate((keys, keys[::-1])):
            for key in order:
                if rnd == 0 and not key[1].startswith("probe"):
                    sub = [t[:, :700] for t in (q, k, v)]
                    want = flash_attention_plain(*(t.double() for t in sub))
                    got = _flash(libs[key], *sub).double()
                    ratio = float(((got - want).abs()
                                   / (atol + rtol * want.abs())).max())
                    if ratio > 1:
                        raise RuntimeError(f"{key} {shape}: {ratio}")
                ms.setdefault(f"{key[1]} {list(shape)}", []).append(
                    smoke.device_ms(lambda: _flash(libs[key], q, k, v)))
    records.append({"source": "flash_attention", "causal": True, "ms": ms,
                    "nvidia_smi": smi})

    for rec in records:
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
