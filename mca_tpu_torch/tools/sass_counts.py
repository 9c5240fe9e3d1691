"""Count the tensor-core and MUFU instructions of each built kernel.

    python -m mca_tpu_torch.tools.sass_counts [name ...]

Builds ``csrc/<name>.cu`` (every kernel when no name is given), runs
``cuobjdump -sass`` on the library and prints, per ``Function :``
section, its HMMA (mma.sync), HGMMA (wgmma), UTMALDG (TMA tensor
load), MUFU.EX2 and branch instructions and its SASS lines.
A loop the compiler did not unroll holds exactly one iteration's worth,
so the counts show dead work the compiler dropped (fewer products than
the body asks for) or a body that outgrew the instruction cache (many
more lines).  Needs the CUDA toolkit; runs no kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from typing import Dict

from mca_tpu_torch import _build

_SECTION = re.compile(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", re.S)
_COUNTED = {
    "HMMA": r"\bHMMA\.",  # mma.sync
    "HGMMA": r"\bHGMMA\.",  # wgmma
    "UTMALDG": r"\bUTMALDG\b",  # TMA tensor load
    "MUFU.EX2": r"\bMUFU\.EX2\b",
    "BRA": r"\bBRA\b",
}


def count(sass: str) -> Dict[str, Dict[str, int]]:
    """``{function: {"HMMA", "HGMMA", "UTMALDG", "MUFU.EX2", "BRA",
    "lines"}}`` of
    ``cuobjdump -sass`` output."""
    out = {}
    for fn, body in _SECTION.findall(sass):
        c = {k: len(re.findall(pat, body)) for k, pat in _COUNTED.items()}
        c["lines"] = sum(1 for line in body.splitlines() if line.strip())
        out[fn] = c
    return out


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: needs the CUDA toolkit")
    return found


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="*", default=list(_build.KERNELS))
    args = ap.parse_args(argv)
    tool = cuobjdump_path()
    _build.build(args.names)
    report = {}
    for name in args.names:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        report[name] = count(sass)
        for fn, c in report[name].items():
            print(f"{name} {fn}: {c}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
