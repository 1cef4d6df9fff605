#!/usr/bin/env python3
"""Time the dense decode kernel (kernel 9) of two checkouts on one
card, in turns.

    python3 decode_compare.py OTHER_CHECKOUT [THIS_CHECKOUT]

Runs each checkout's own ``chip_smoke._decode_timing`` (b 8, h 8, g 8,
dh 64, T 544; CUDA-graph replay over seeded cache sets) at the serving
mix's lengths and at full context (every row 544), float32 and
bfloat16, one process per run, in the order other, this, this, other,
so that a drift of the card over the call shows in both. Each process
builds its checkout's decode kernel from that checkout's sources. Prints
each run's times as a JSON line, then the card's name and power limit.
Needs one CUDA card; exits non-zero when a run fails.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

# run inside each checkout: its own chip_smoke.py and paddle_tpu_torch
RUN = """
import json, sys, torch
import chip_smoke as c
out = {}
for label, lens in json.loads(sys.argv[1]).items():
    for dtype in (torch.float32, torch.bfloat16):
        t = c._decode_timing(lens, dtype)
        out[f"{label} {str(dtype)[6:]}"] = t["ms"] * 1e3
print("RESULT " + json.dumps(out), flush=True)
"""


def main(argv):
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    other = Path(argv[1]).resolve()
    this = Path(argv[2]).resolve() if len(argv) == 3 else here
    sys.path.insert(0, str(this))
    import chip_smoke
    lens = {"engine lengths": chip_smoke.engine_lengths(),
            "full context": [chip_smoke.DECODE_T] * chip_smoke.SLOTS}
    print(json.dumps({"lens": lens}), flush=True)
    for name, tree in (("other", other), ("this", this), ("this", this),
                       ("other", other)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run([sys.executable, "-c", RUN, json.dumps(lens)],
                             cwd=tree, env=env, capture_output=True,
                             text=True, timeout=900)
        sys.stderr.write(res.stdout + res.stderr)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if res.returncode != 0 or not line:
            print(f"decode_compare: run in {tree} failed "
                  f"(exit {res.returncode})", file=sys.stderr)
            return 1
        print(json.dumps({"tree": name, "path": str(tree),
                          "us": json.loads(line[0][7:])}), flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
