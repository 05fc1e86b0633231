"""Compare the compiled SASS of this tree's CUDA kernels with another tree's.

Run on a machine with ``nvcc`` and ``cuobjdump``, from the root of this tree,
with the root of the other tree (for instance its parent commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists):

    python -m qmmx_monolithic_monte_carlo_tpu_torch.utils.sass_diff build/parent

Each tree builds its own sources with its own ``utils/build.py`` (one
``nvcc`` per source, all at once).  For every source the two trees share,
every kernel and device function of the other tree's library is compared
instruction by instruction with this tree's (addresses and encodings
dropped), found by its mangled name or else by its name and template
arguments (``key``: a kernel given another parameter is still compared).  Prints one line per function and, last, a JSON object {"sources":
..., "functions": n, "identical": n, "differ": [...]}; exits 1 if a function
differs or is missing.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

_BUILD = ("import glob, json\n"
          "from qmmx_monolithic_monte_carlo_tpu_torch.utils import build\n"
          "names = [p.split('/')[-1][:-3] for p in sorted(glob.glob("
          "'qmmx_monolithic_monte_carlo_tpu_torch/ops/csrc/*.cu'))]\n"
          "paths = build.build_all(names)\n"
          "print(json.dumps(dict(zip(names, map(str, paths)))))\n")


def build_tree(root: Path) -> dict:
    """{source: library path} of the tree at ``root``, built by its own
    build module."""
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def functions(library: str) -> dict:
    """{function name: [instructions]} of ``cuobjdump -sass library``."""
    text = subprocess.run(["cuobjdump", "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip())
    return out


def key(name: str) -> str:
    """A mangled function name without its parameters: the name and its
    integer template arguments (``_Z3fooILi8ELi1EEvPKf`` -> ``fooILi8ELi1EE``)."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    n, i = int(m.group(1)), m.end()
    t = re.match(r"I(?:L[a-z]+n?\d+E)*E", name[i + n:])
    return name[i:i + n] + (t.group(0) if t else "")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    here, other = Path.cwd(), Path(argv[0]).resolve()
    mine, theirs = build_tree(here), build_tree(other)
    shared = sorted(set(mine) & set(theirs))
    n, same, differ = 0, 0, []
    for src in shared:
        a, b = functions(theirs[src]), functions(mine[src])
        by_key = {key(g): g for g in b}
        for f in sorted(a):
            n += 1
            g = f if f in b else by_key.get(key(f))
            if g is not None and a[f] == b[g]:
                same += 1
                state = "identical" if g == f else f"identical as {g[:60]}"
            else:
                differ.append(f"{src}:{f}")
                state = (f"DIFFERS ({len(a[f])} vs {len(b[g])} instructions)" if g is not None
                         else "MISSING")
            print(f"{src} {f[:90]} {state}")
    print(json.dumps({"sources": shared, "functions": n, "identical": same, "differ": differ}))
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
