#!/usr/bin/env python3
"""
What the phases of kernel K1 (pyshepseg_tpu_torch/csrc/local_ccl.cu) cost
on the card: the kernel as committed, timed against variants made by
string edits of the same source, each built with nvcc into
build/k1_variants/ and loaded with ctypes. Needs a CUDA card and nvcc;
imports nothing of JAX.

    python3 scripts/torch_k1_variants.py

Variants (a variant whose output differs from the plain version is marked
"differs": it skips work the contract needs, and is timed only to price
that work):

- no_union: run heads are never joined (prices the union-find phase);
- no_flatten: heads are not pointed at their roots, labels read one hop
  (prices the flatten pass);
- no_halving: finds do not halve their paths;
- int32_parent: 32-bit parents (5 bytes a pixel of shared memory);
- threads1024: 1024 threads a block at every block shape.

Prints one line per image, connectivity and block shape, with each
variant's kernel ms (CUDA events behind a device-side sleep).
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pyshepseg_tpu_torch import _kernels  # noqa: E402
from pyshepseg_tpu_torch.ops import local_ccl  # noqa: E402

SOURCE = os.path.join(ROOT, "pyshepseg_tpu_torch", "csrc", "local_ccl.cu")
OUT = os.path.join(ROOT, "build", "k1_variants")


def edits():
    """name -> list of (old, new) replacements of the source."""
    joins = [("if (f & %s) unite" % flag, "if (false) unite")
             for flag in ("kJoinLeft", "kJoinUp", "kJoinUpLeft",
                          "kJoinUpRight")]
    return {
        "as committed": [],
        "no_union": joins,
        "no_flatten": [
            ("parent[i] = (unsigned short)find_root(parent, i);", "{}"),
            ("const int r = parent[parent[i]];",
             "const int r = parent[i];")],
        "no_halving": [("    parent[x] = (unsigned short)g;\n", "")],
        "int32_parent": [
            ("unsigned short", "int"),
            ("unsigned char* flags = smem + 2 * n;",
             "unsigned char* flags = smem + 4 * n;"),
            ("s.smem = 3 * ((size_t)by << s.shift);",
             "s.smem = 5 * ((size_t)by << s.shift);")],
        "threads1024": [
            ("s.threads = s.smem > 3 * 128 * 128 ? 1024 : 512;",
             "s.threads = 1024;")],
    }


def build():
    """Compile every variant in parallel; returns name -> ctypes library."""
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = []
    for i, (name, subs) in enumerate(edits().items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError("variant %s: %r is not in the source"
                                   % (name, old))
            src = src.replace(old, new)
        cu = os.path.join(OUT, "v%d.cu" % i)
        so = os.path.join(OUT, "v%d.so" % i)
        with open(cu, "w") as f:
            f.write(src)
        cmd = [_kernels._nvcc()] + _kernels.NVCC_FLAGS + [
            "-shared", "-o", so, cu]
        procs.append((name, so, cmd, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s: %s" % (name, err))
        lib = ctypes.CDLL(so)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.local_ccl_launch.restype = i32
        lib.local_ccl_launch.argtypes = [vp, vp, i32, i32, i32, i32, i32,
                                         i32, vp]
        libs[name] = lib
    return libs


def launch(lib, img, out, block, four):
    code = lib.local_ccl_launch(
        img.data_ptr(), out.data_ptr(), img.shape[0], img.shape[1],
        block[0], block[1], 0, int(four),
        torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, "local_ccl variant")


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def images(rng):
    """Random clusters (4 values, 10 % null) at 1024^2 and 4096^2, and
    64 x 64 squares of random clusters at 4096^2 (large components)."""
    def clusters(shape):
        c = rng.integers(1, 5, size=shape).astype(np.int32)
        c[rng.random(shape) < 0.1] = 0
        return torch.from_numpy(c).cuda()
    squares = clusters((64, 64)).repeat_interleave(64, 0).repeat_interleave(
        64, 1).contiguous()
    return {"random 1024^2": clusters((1024, 1024)),
            "random 4096^2": clusters((4096, 4096)),
            "squares 4096^2": squares}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_variants: no CUDA device")
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    libs = build()
    for what, img in images(np.random.default_rng(0)).items():
        out = torch.empty_like(img)
        for four in (True, False):
            for block in [(128, 128), (64, 64)]:
                want = local_ccl.local_ccl_blocks_reference(img, 0, four,
                                                            block=block)
                cells = []
                for name, lib in libs.items():
                    launch(lib, img, out, block, four)
                    torch.cuda.synchronize()
                    same = torch.equal(out, want)
                    ms = cuda_ms(lambda: launch(lib, img, out, block, four))
                    cells.append("%s %.4f%s" % (name, ms,
                                                "" if same else " differs"))
                print("%s four=%s block %s: %s"
                      % (what, four, block, " | ".join(cells)), flush=True)


if __name__ == "__main__":
    main()
