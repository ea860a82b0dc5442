"""Compares the machine code (SASS) of CUDA kernels between two builds of
the port's kernel library, to show that a change left some kernels as they
were.

    python scripts/sass_diff.py LIB_A LIB_B WORD [WORD ...]

For each WORD, the kernels whose mangled name contains it are disassembled
from both libraries with cuobjdump (CUDA toolkit, under /usr/local/cuda or
$CUDA_HOME) and compared instruction by instruction, addresses and
encodings aside; a kernel that several sources include has a copy in each.
Prints one line per WORD: identical when every copy in either library
equals every other.
"""
import os
import re
import subprocess
import sys


def kernels(lib):
    """{mangled kernel name: [instruction text, ...]} of a library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    res, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            res[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", ln)
            if m:
                res[name].append(m.group(1).strip())
    return res


def main():
    a, b = kernels(sys.argv[1]), kernels(sys.argv[2])
    for word in sys.argv[3:]:
        fa = [v for k, v in a.items() if word in k]
        fb = [v for k, v in b.items() if word in k]
        same = bool(fa and fb) and all(f == fa[0] for f in fa + fb)
        print(f"SASS {word}: {len(fa)} copies in the first library, "
              f"{len(fb)} in the second, "
              f"{sorted({len(f) for f in fa + fb})} instructions; "
              f"identical: {same}")


if __name__ == "__main__":
    main()
