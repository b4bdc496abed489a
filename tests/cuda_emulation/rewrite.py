"""Compile a kernel source of `automodel_tpu_torch/csrc/` for the CPU.

`emulated_source` rewrites the CUDA-only syntax of a `.cu` file for g++
against `cuda_emulation.h` (beside this file); `build` compiles the result
into a shared library. The source's local headers are inlined, and its
inline-asm helpers (`ASM_HELPERS`, from `csrc/mma_helpers.cuh`) are
removed so that the emulation header's ones take their place.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

HEADER_DIR = Path(__file__).resolve().parent
# the inline-asm helpers of csrc/mma_helpers.cuh, emulated in the header
ASM_HELPERS = ("cp_async16", "cp_async4", "cp_async_commit", "cp_async_wait",
               "ldsm_x4", "ldsm_x4_trans", "mma_bf16", "fast_exp2")


def emulated_source(source: Path) -> str:
    """The kernel source, its local headers inlined, with CUDA-only syntax
    rewritten for g++."""
    text = re.sub(r'#include "([\w.]+)"\n',
                  lambda m: (source.parent / m.group(1)).read_text()
                  .replace("#pragma once\n", ""), source.read_text())
    for name in ASM_HELPERS:
        m = re.search(r"(template <int N>\n)?__device__ __forceinline__ "
                      rf"(?:void|float|uint32_t) {name}\(", text)
        assert m, name
        depth, j = 0, text.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            if depth == 0:
                break
            j += 1
        text = text[:m.start()] + text[j + 1:]
    text = text.replace("#include <cuda_bf16.h>", '#include "cuda_emulation.h"')
    text = text.replace("#include <cuda_runtime.h>", "")
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(g_smem);", text)
    # kernel<<<grid, threads, smem, stream>>>(args) ->
    # emu_launch(grid, threads, smem, [=] { kernel(args); })
    out, pos = [], 0
    launch = re.compile(r"([\w:]+<[^<>;]*>)<<<([^>]*)>>>\(")
    while (m := launch.search(text, pos)) is not None:
        grid, threads, smem, _ = (x.strip() for x in m.group(2).split(","))
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        out += [text[pos:m.start()], f"emu_launch({grid}, {threads}, {smem}, "
                f"[=] {{ {m.group(1)}({text[m.end():j - 1]}); }})"]
        pos = j
    return "".join(out) + text[pos:]


def build(gxx: str, source: Path, out_dir: Path) -> Path:
    """Compile `source` (a .cu file) for the CPU into `out_dir`; returns the
    shared library's path. Unoptimised (-O0): on the emulation's fibers the
    kernels run in seconds, and g++ -O2 takes four times as long to compile
    a source as -O0 does."""
    src = out_dir / f"{source.stem}_emulated.cpp"
    src.write_text(emulated_source(source))
    so = out_dir / f"{source.stem}_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O0", "-shared", "-fPIC",
                          f"-I{HEADER_DIR}", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{res.stderr}")
    return so
