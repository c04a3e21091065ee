"""Where the flash-attention kernel's time goes, on one NVIDIA GPU.

    python -m atomo_tpu_torch.ops.flash_phases

Builds ``csrc/flash_attention.cu`` as it is and in variants that each cut one
phase of the key-tile loop (their outputs are wrong, their times are not),
then times every variant at the LM recipe's float32 causal shape (B 16, H 4,
S 1024, D 64, on the strided head views of a fused qkv projection, 4
launches a step) by CUDA events, in turns, median of 10. A phase's share is
the base time less the variant's (phases overlap, so the shares need not
add up). The variants build into ``build/kernels/flash_phases/``. Prints one
line per variant and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from atomo_tpu_torch.ops import _build

SHAPE = (16, 4, 1024, 64)
LAUNCHES = 4  # one per layer of the recipe's step

# variant -> (text of the kernel's loop, its replacement)
CUTS = {
    "base": [],
    "no_split": [("      split_kv(ops + ((j + 1) & 1) * L::kOps);\n", "")],
    "no_exp": [("p0 = exp2_ftz(p0 - z0);", "p0 = (p0 - z0);"),
               ("p1 = exp2_ftz(p1 - z1);", "p1 = (p1 - z1);")],
    "no_pv": [("    add_pv<T, D, BK>(acc, s, kb + kParts<T> * L::kKPart, L::kVPart);\n",
               "    acc[0] += s[0] + s[BK / 2 - 1];\n")],
    "no_scores": [("    issue_scores<T, D, BK>(s, qa, L::kQPart, kb, L::kKPart);\n",
                   "    for (int i = 0; i < BK / 2; ++i) s[i] = (float)(i + tid);\n"),
                  ("    wgmma_wait0();\n    fence_regs(s);\n", "")],
    "one_tf32_pass": [("      mma_ss<T, BK>(s, al, bh);\n      mma_ss<T, BK>(s, ah, bl);\n", ""),
                      ("      mma_rs<T, D>(o, al[m], bh);\n      mma_rs<T, D>(o, ah[m], bl);\n",
                       "")],
    "no_next_loads": [("      if (j + 2 < n_tiles) load_kv(k0 + 2 * BK);\n", "")],
}


def build(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """One library per variant, compiled in parallel."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_forward.argtypes = [p, p, p, p, i, i, i, i, p, i, i,
                                                ctypes.c_float, p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_phases: no CUDA device")
    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    out = torch.empty(SHAPE, device="cuda")
    strides = (ctypes.c_longlong * 9)(*(st for t in (q, k, v) for st in t.stride()[:3]))

    def step(lib):
        for _ in range(LAUNCHES):
            rc = lib.flash_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
                ctypes.cast(strides, ctypes.c_void_p), 0, 1, d ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

    out_dir = _build.BUILD_DIR / "flash_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)
    times: dict[str, list[float]] = {name: [] for name in libs}
    for lib in libs.values():
        step(lib)
    for rnd in range(10):
        order = list(libs.items())
        for name, lib in order if rnd % 2 == 0 else reversed(order):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(lib)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    base = statistics.median(times["base"])
    for name, t in times.items():
        ms = statistics.median(t)
        print(f"flash phase {name}: {ms:.4f} ms per step ({LAUNCHES} launches), "
              f"the cut saves {base - ms:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
