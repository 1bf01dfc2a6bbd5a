"""Compare two builds of a kernel library, kernel by kernel, by their SASS.

    python3 tools/sass_compare.py NEW.so OLD.so [--match REGEX]

Runs ``cuobjdump -sass`` (the CUDA toolkit's, under CUDA_HOME or on PATH)
on both shared libraries, splits each listing into its functions, and
prints one JSON line per function name found in either: whether both
builds hold it, whether its instructions are the same, and how many each
has. Names are compared with the anonymous namespace's per-file hash
taken out, so the same kernel built from two checkouts matches; the
instructions are compared with their encodings, offsets included.
``--match`` keeps the functions whose name matches the regex. A last line
counts the functions that are equal, differ, or are in one build only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found (set CUDA_HOME)")


def functions(path: str) -> dict[str, list[str]]:
    """{normalized name: its SASS instruction lines} of a library."""
    text = subprocess.run([cuobjdump(), "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("_GLOBAL__N_", m.group(1))
            out[name] = []
        elif name is not None and "/*" in line:
            out[name].append(line.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("new")
    ap.add_argument("old")
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    new, old = functions(args.new), functions(args.old)
    keep = re.compile(args.match)
    counts = {"equal": 0, "differ": 0, "one_build": 0}
    for name in sorted(set(new) | set(old)):
        if not keep.search(name):
            continue
        a, b = new.get(name), old.get(name)
        same = a is not None and a == b
        key = ("one_build" if a is None or b is None
               else "equal" if same else "differ")
        counts[key] += 1
        print(json.dumps({"function": name, "in_new": a is not None,
                          "in_old": b is not None, "equal": same,
                          "instructions_new": len(a or ()),
                          "instructions_old": len(b or ())}))
    print(json.dumps({"new": args.new, "old": args.old, **counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
