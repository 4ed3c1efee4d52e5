#!/usr/bin/env python3
"""Compare the machine code (SASS) of kernels in two builds of the kernel
library.

    python3 cdlnet_tpu_torch/tools/compare_sass.py OLD.so NEW.so NAME [NAME ...]

cuobjdump, from the CUDA toolkit beside nvcc, disassembles both libraries
(kernels/_build/cdlnet_kernels_*.so: kernels/_build.py builds them). For
each NAME the kernels whose mangled names contain it are paired in sorted
order, and each pair's instructions, without addresses and encodings, are
compared. NAME may be OLD_NAME=NEW_NAME, for a kernel whose mangled name
changed (a kernel that became one instantiation of a template). It prints one line a pair and exits 1 if any pair differs or
pairs up unevenly: equal SASS runs the same instructions, so it gives
bitwise the same outputs at the same speed. A change that only moves code
between headers, or renames the namespace of a kernel's argument type,
shows here as equal.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys


def parse(text: str) -> dict:
    """{mangled kernel name: [instruction, ...]} of cuobjdump -sass output,
    each instruction without its address and encoding comments."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and "/*" in line:
            ins = " ".join(re.sub(r"/\*.*?\*/", "", line).split())
            if ins:
                out[name].append(ins)
    return out


def disassemble(so: str) -> dict:
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return parse(subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                                check=True).stdout)


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = disassemble(argv[0]), disassemble(argv[1])
    same = True
    for key in argv[2:]:
        key_old, _, key_new = key.partition("=")
        a = sorted(k for k in old if key_old in k)
        b = sorted(k for k in new if (key_new or key_old) in k)
        if len(a) != len(b) or not a:
            print(f"{key}: {len(a)} kernels in the old build, {len(b)} in the new")
            same = False
        for x, y in zip(a, b):
            eq = old[x] == new[y]
            same &= eq
            print(f"{key}: {x} / {y}: {len(old[x])} / {len(new[y])} instructions, "
                  f"{'equal' if eq else 'different'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
